"""Flash-decoding: one query token per sequence against a KV cache, the
``decode_attention`` kernel (each decode step).

q is (B, Hq, D), k and v (B, S, Hkv, D), the cache's own layout; the keys
``j < valid_len`` take part, softmax in float32, output (B, Hq, D) in q's
dtype.  ``valid_len`` is a host int: the serving loop knows the cache
length, so the launch covers exactly the filled keys.  There is no window;
a sliding-window layer hands in the window's slice of the cache (a view:
the kernel reads k and v through their strides).  The CUDA kernel is
``csrc/decode_attention.cu`` (a split over chunks of 64 keys, then a
combine); ``decode_attention_plain`` computes the same function with
float32 arithmetic in PyTorch ops.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES, NEG_INF

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


@functools.cache
def _lib():
    lib = _build.library("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = ([_c_void_p] * 5 + [_c_int] * 6 + [_c_ll] * 10
                   + [_c_float, _c_void_p])
    fn.restype = _c_int
    scratch = lib.decode_attention_scratch
    scratch.argtypes = [_c_int] * 5
    scratch.restype = _c_ll
    return fn, scratch


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len: int) -> torch.Tensor:
    """Launch the split and combine kernels on the current stream.  Inputs
    must already be validated (``ops.attention_decode`` does it)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    launch, scratch = _lib()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((scratch(b, hkv, hq // hkv, d, valid_len),),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    part.data_ptr(), DTYPE_CODES[q.dtype], b, hkv, hq // hkv,
                    d, valid_len, *q.stride()[:2], *k.stride()[:3],
                    *v.stride()[:3], *out.stride()[:2], 1.0 / math.sqrt(d),
                    stream)
    _build.check(status, "decode_attention")
    return out
