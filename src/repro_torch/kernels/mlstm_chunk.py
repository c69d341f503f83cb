"""Chunkwise mLSTM over a whole sequence: the ``mlstm_chunk`` kernel (the
xLSTM prefill and no-cache forward, once per mLSTM layer).

q, k and v are (B, H, S, Dh), the gates (B, H, S) pre-activations, all of
one dtype (float32 or bfloat16); the arithmetic is float32.  Per (batch,
head) it computes ``models.ssm.mlstm_chunkwise``: the outputs y (in q's
dtype) and the final recurrent state (C (Dh, Dh), n (Dh,), m ()) in
float32, from an initial state (C = 0, n = 0, m = -1e30 by default).  The
TPU kernel keeps the state in scratch and returns y only; this one writes
the state out, so the serve path's prefill fills the decode cache with it.

The CUDA kernel is ``csrc/mlstm_chunk.cu``.  It reads q, k, v and the
gates through their (batch, head, position) strides (the model hands in
transposed views of its projections, no copies), takes any S >= 1 (the
last chunk's edge masked), and writes y in a (B, S, H, Dh) buffer returned
as a (B, H, S, Dh) view, so the model's transpose back is free.
``mlstm_chunk_plain`` is ``ssm.mlstm_chunkwise`` with the JAX model's
chunk choice (256, or the whole sequence where 256 does not divide it).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)

CHUNK = 64          # the CUDA kernel's chunk length (its own choice)
PLAIN_CHUNK = 256   # the JAX model's (ssm.apply_mlstm)


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_gate: torch.Tensor, f_gate: torch.Tensor,
                      state=None):
    """Plain PyTorch version of the kernel -> (y, (C, n, m))."""
    from repro_torch.models import ssm  # lazy, as the JAX package's ref.py

    s = q.shape[2]
    chunk = min(PLAIN_CHUNK, s)
    return ssm.mlstm_chunkwise(q, k, v, i_gate, f_gate, state,
                               chunk=chunk if s % chunk == 0 else s)


@functools.cache
def _lib():
    fn = _build.library("mlstm_chunk").mlstm_chunk_launch
    fn.argtypes = ([_c_void_p] * 12 + [_c_int] * 5 + [_c_ll] * 18
                   + [_c_float, _c_void_p])
    fn.restype = _c_int
    return fn


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_gate: torch.Tensor, f_gate: torch.Tensor, state=None):
    """Launch the CUDA kernel on the current stream -> (y, (C, n, m)).
    Inputs must already be validated (``ops.mlstm`` does it)."""
    b, h, s, dh = q.shape
    dev = q.device
    y = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    out = torch.empty((b * h * (dh * dh + dh + 1),), dtype=torch.float32,
                      device=dev)
    c1 = out[:b * h * dh * dh].view(b, h, dh, dh)
    n1 = out[b * h * dh * dh:b * h * (dh * dh + dh)].view(b, h, dh)
    m1 = out[b * h * (dh * dh + dh):].view(b, h)
    c0, n0, m0 = (0, 0, 0) if state is None else (x.data_ptr() for x in state)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    i_gate.data_ptr(), f_gate.data_ptr(), y.data_ptr(),
                    c0, n0, m0, c1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
                    DTYPE_CODES[q.dtype], b, h, s, dh,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *i_gate.stride(), *f_gate.stride(), *y.stride()[:3],
                    math.sqrt(dh), stream)
    _build.check(status, "mlstm_chunk")
    return y, (c1, n1, m1)
