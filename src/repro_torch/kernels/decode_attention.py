"""Flash-decoding: one query token per sequence against a KV cache, the
``decode_attention`` kernel (each decode step).

q is (B, Hq, D), k and v (B, S, Hkv, D), the cache's own layout; the keys
``j < valid_len`` take part, softmax in float32, output (B, Hq, D) in q's
dtype.  ``valid_len`` is a host int: the serving loop knows the cache
length, so the launch covers exactly the filled keys.  There is no window;
a sliding-window layer hands in the window's slice of the cache (a view:
the kernel reads k and v through their strides).  The CUDA kernel is
``csrc/decode_attention.cu``: one launch that splits the keys of each
(batch, KV head) over ``split_plan`` blocks and merges their partials in
the same launch, in the blocks that finish last; ``decode_attention_plain``
computes the same function with float32 arithmetic in PyTorch ops.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES, NEG_INF

MIN_KEYS_PER_SPLIT = 16
MAX_SPLITS = 256        # the kernel's bound on splits per (batch, KV head)
BLOCKS_PER_SM = 2

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (
        1.0 / math.sqrt(d))
    valid = torch.arange(s, device=q.device) < valid_len
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def split_plan(bh: int, valid_len: int, n_sms: int) -> int:
    """Key splits per (batch, KV head): enough for BLOCKS_PER_SM blocks per
    SM over the ``bh`` (batch, KV head) pairs, with at least
    MIN_KEYS_PER_SPLIT keys a split (one split below that), at most
    MAX_SPLITS."""
    want = -(-BLOCKS_PER_SM * n_sms // bh)
    return max(1, min(want, valid_len // MIN_KEYS_PER_SPLIT, MAX_SPLITS))


def split_bounds(valid_len: int, n_splits: int) -> list[tuple[int, int]]:
    """The keys [lo, hi) of each split, as the kernel cuts them."""
    return [(i * valid_len // n_splits, (i + 1) * valid_len // n_splits)
            for i in range(n_splits)]


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The in-launch merge's int32 counters (two per (batch, KV head): the
    tickets and the mergers past their wait): zeros, allocated once per
    device (grown when a call needs more); every launch leaves them
    zero."""
    cached = _COUNTERS.get(device)
    if cached is None or cached.numel() < n:
        cached = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[device] = cached
    return cached


@functools.cache
def _lib():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.argtypes = ([_c_void_p] * 6 + [_c_int] * 7 + [_c_ll] * 10
                   + [_c_float, _c_void_p])
    fn.restype = _c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len: int) -> torch.Tensor:
    """Launch the kernel on the current stream.  Inputs must already be
    validated (``ops.attention_decode`` does it)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    n_splits = split_plan(b * hkv, valid_len, _sm_count(q.device))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b * hkv * n_splits * g * (d + 2),),
                       dtype=torch.float32, device=q.device)
    counters = _counters(q.device, 2 * b * hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    part.data_ptr(), counters.data_ptr(), DTYPE_CODES[q.dtype],
                    b, hkv, g, d, valid_len, n_splits, *q.stride()[:2],
                    *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
                    1.0 / math.sqrt(d), stream)
    _build.check(status, "decode_attention")
    return out
