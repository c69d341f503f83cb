"""Causal / sliding-window grouped-query attention over a whole sequence:
the ``flash_attention`` kernel (prefill, an encoder, cross-attention).

q is (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), the JAX kernel's layout
(Skv is its ``kv_len``; Skv = Sq under the causal mask); G = Hq / Hkv
query heads share a KV head.  Row i attends to the keys j <= i
(``causal``) with i - j < ``window`` (``window`` > 0), softmax in float32,
output in q's dtype.  ``softcap`` c > 0 turns each scaled logit x into
c tanh(x / c) before the mask (``layers.attention``'s soft cap).  The CUDA
kernel is ``csrc/flash_attention.cu``: it reads every tensor through its
(batch, head, position) strides, so a transposed view of a (B, S, H, D)
tensor goes in without a copy, and it writes its output in q's own layout
(``torch.empty_like``).  In bfloat16
it loads k and v by TMA through tensor maps it encodes per call over those
views (rows 16-byte aligned, no broadcast dims: ``ops.attention`` checks)
and multiplies with ``wgmma``; float32 runs on the FMA units.
``flash_attention_plain`` computes the same function with float32
arithmetic in PyTorch ops (q, k and v upcast, one materialized softmax,
the result cast to q's dtype), as the TPU kernel does in its blocks.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)


def softcapped(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    """c tanh(x / c) of float32 scaled logits (c = ``softcap`` > 0), or
    the logits themselves at c = 0."""
    return softcap * torch.tanh(scores / softcap) if softcap > 0 else scores


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, Hq, Sq, D) in q's
    dtype."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    scores = softcapped(torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
                        * (1.0 / math.sqrt(d)), softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= rows - cols < window
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


@functools.cache
def _lib():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([_c_void_p] * 4 + [_c_int] * 7 + [_c_ll] * 12
                   + [_c_int] * 2 + [_c_float, _c_float, _c_void_p])
    fn.restype = _c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Inputs must already be
    validated (``ops.attention`` does it)."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[q.dtype], b, hkv, hq // hkv, s, skv, d,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], int(causal), int(window),
                    1.0 / math.sqrt(d), float(softcap), stream)
    _build.check(status, "flash_attention")
    return out
