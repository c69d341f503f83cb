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
Beside the output, the kernel writes each row's log-sum-exp L of its
masked, soft-capped logits (float32 (B, Hq, Sq), natural log; 4 bytes a
row) for the backward.  ``flash_attention_plain_lse`` computes both with
float32 arithmetic in PyTorch ops (q, k and v upcast, one materialized
softmax, the output cast to q's dtype), as the TPU kernel does in its
blocks; ``flash_attention_plain`` is its output alone.

The backward (no TPU counterpart: the JAX model differentiates its plain
chunked attention) is ``csrc/flash_attention_bwd.cu``.  It takes L from
the forward and does not recompute it.  In bfloat16 it is three kernels:
Delta = rowsum(dO o), then dk and dv (a block a tile of 64 keys walking
the G heads' position tiles that see it, two warpgroups on ``wgmma``:
S^T, P^T and dV, then dP^T, dS^T and dK), then dq (as the forward, K and
V by TMA); in float32 two on the FMA units: dq with Delta, then dk and dv.
The G heads are summed in the block in a fixed order: no atomics, the
same bits on every run.  ``flash_attention_bwd_plain`` is the same
formula in PyTorch ops, P formed from the L it is given.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _bisect, _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)


def softcapped(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    """c tanh(x / c) of float32 scaled logits (c = ``softcap`` > 0), or
    the logits themselves at c = 0."""
    return softcap * torch.tanh(scores / softcap) if softcap > 0 else scores


def _scores(qg: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            softcap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (B, Hkv, G, Sq, Skv) soft-capped logits of grouped queries,
    and the same with NEG_INF where the mask drops the key."""
    d = qg.shape[-1]
    scores = softcapped(torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
                        * (1.0 / math.sqrt(d)), softcap)
    rows = torch.arange(qg.shape[3], device=qg.device)[:, None]
    cols = torch.arange(k.shape[2], device=qg.device)[None, :]
    mask = torch.ones((rows.shape[0], cols.shape[1]), dtype=torch.bool,
                      device=qg.device)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= rows - cols < window
    return scores, torch.where(mask, scores, NEG_INF)


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> ((B, Hq, Sq, D) in q's dtype,
    L (B, Hq, Sq) float32): the output and each row's log-sum-exp of its
    masked, soft-capped float32 logits (natural log), which the kernels
    write for the backward."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    _, masked = _scores(qg, k, causal, window, softcap)
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(masked, dim=-1),
                       v.float())
    return (out.reshape(b, hq, s, d).to(q.dtype),
            torch.logsumexp(masked, dim=-1).reshape(b, hq, s))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, Hq, Sq, D) in q's
    dtype."""
    return flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                     softcap=softcap)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward kernels -> (dq, dk, dv) in the inputs'
    dtypes: P = exp(x - L) from the logits recomputed from q and k and the
    forward's log-sum-exp ``lse``, as the kernels form it, Delta =
    rowsum(dO o) from the forward's output ``o``, dS = P (dP - Delta),
    times 1 - (x / c)^2 under the soft cap c, then the three products, all
    in float32."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, s, d)
    dog = dout.float().reshape(b, hkv, g, s, d)
    scores, masked = _scores(qg, k, causal, window, softcap)
    probs = torch.exp(masked - lse.float().reshape(b, hkv, g, s, 1))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", probs, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    delta = torch.sum(dog * o.float().reshape(b, hkv, g, s, d), dim=-1,
                      keepdim=True)
    ds = probs * (dp - delta) * (1.0 / math.sqrt(d))
    if softcap > 0:
        ds = ds * (1.0 - torch.square(scores / softcap))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _lib():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([_c_void_p] * 5 + [_c_int] * 7 + [_c_ll] * 12
                   + [_c_int] * 2 + [_c_float, _c_float, _c_void_p])
    fn.restype = _c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream -> (out, L (B, Hq, Sq)
    float32).  Inputs must already be validated (``ops.attention`` does
    it)."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), DTYPE_CODES[q.dtype], b, hkv, hq // hkv,
                    s, skv, d, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *out.stride()[:3], int(causal),
                    int(window), 1.0 / math.sqrt(d), float(softcap), stream)
    _build.check(status, "flash_attention")
    return out, lse


@functools.cache
def _bwd_lib():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([_c_void_p] * 10 + [_c_int] * 7 + [_c_void_p]
                   + [_c_int] * 2 + [_c_float, _c_float, _c_void_p, _c_int,
                                     _c_void_p])
    fn.restype = _c_int
    return fn


def dkdv_splits(blocks: int, sms: int) -> int:
    """Ways the bf16 dk/dv kernel splits each key tile's (head, position
    tile) list, 1 to 8: about two blocks an SM where there are fewer key
    tiles (under the causal mask the first tiles carry the most work, so
    one block an SM leaves the card waiting on them).  Above 1 the float32
    parts are summed in a fixed order."""
    return max(1, min(8, 2 * sms // max(blocks, 1)))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the backward kernels on the current stream (bfloat16: Delta,
    dk and dv, their sum over splits where ``dkdv_splits`` > 1, dq;
    float32: dq with Delta, then dk and dv) -> (dq, dk, dv) in the layouts
    of q, k and v.  ``lse`` is the forward's (B, Hq, Sq) float32,
    contiguous.  Inputs must already be validated (``ops``'
    ``flash_attention_bwd`` op does it)."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    n_split, part = 1, None
    if q.dtype == torch.bfloat16:
        n_split = dkdv_splits(b * hkv * -(-skv // 64),
                              _bisect.sm_count(q.device))
    if n_split > 1:
        part = torch.empty((n_split, 2, b * hkv, skv, d), dtype=torch.float32,
                           device=q.device)
    strides = [st for x in (q, k, v, o, dout, dq, dk, dv)
               for st in x.stride()[:3]]
    status = _bwd_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), DTYPE_CODES[q.dtype], b, hkv,
        hq // hkv, s, skv, d, (_c_ll * len(strides))(*strides), int(causal),
        int(window), 1.0 / math.sqrt(d), float(softcap),
        None if part is None else part.data_ptr(), n_split,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention_bwd")
    return dq, dk, dv
