"""Chunkwise mLSTM over a whole sequence: the ``mlstm_chunk`` kernel (the
xLSTM prefill and no-cache forward, once per mLSTM layer).

q, k and v are (B, H, S, Dh), the gates (B, H, S) pre-activations, all of
one dtype (float32 or bfloat16); the arithmetic is float32.  Per (batch,
head) it computes ``models.ssm.mlstm_chunkwise``: the outputs y (in q's
dtype) and the final recurrent state (C (Dh, Dh), n (Dh,), m ()) in
float32, from an initial state (C = 0, n = 0, m = -1e30 by default).  The
TPU kernel keeps the state in scratch and returns y only; this one writes
the state out, so the serve path's prefill fills the decode cache with it.

The CUDA kernels are in ``csrc/mlstm_chunk.cu``.  They read q, k, v and
the gates through their (batch, head, position) strides (the model hands
in transposed views of its projections, no copies), take any S >= 1 (the
last chunk's edge masked), and write y in a (B, S, H, Dh) buffer returned
as a (B, H, S, Dh) view, so the model's transpose back is free.

* bfloat16: two launches on the tensor cores, over chunks of ``CHUNK``
  (256) positions.  The states kernel writes the state at every chunk's
  start into a scratch buffer (C in bf16, (B, H, n_chunks, Dh, Dh); n and
  m in float32) and the final float32 state; the outputs kernel computes
  y from the scratch.  ``chunk_states_plain`` and ``chunk_outputs_plain``
  are their plain versions: composed, they give ``mlstm_chunk_plain``.
* float32 (the parity path): one launch on the FMA units.

``mlstm_chunk_plain`` is ``ssm.mlstm_chunkwise`` with the JAX model's
chunk choice (256, or the whole sequence where 256 does not divide it).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)

CHUNK = 256         # the bf16 kernels' chunk length (the JAX model's too)
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


def chunk_states_plain(q, k, v, i_gate, f_gate, state=None,
                       chunk: int = CHUNK):
    """Plain version of the states kernel -> (states, final): ``states`` =
    (C_c (B, H, n_chunks, Dh, Dh), n_c (B, H, n_chunks, Dh), m_c (B, H,
    n_chunks)), the float32 state at the start of every chunk of ``chunk``
    positions (the last may be shorter), and the final state (C, n, m)."""
    from repro_torch.models import ssm

    b, h, s, dh = q.shape
    if state is None:
        state = ssm.zero_mlstm_state(b, h, dh, q.device)
    starts = []
    for lo in range(0, s, chunk):
        starts.append(state)
        hi = min(lo + chunk, s)
        _, state = ssm.mlstm_chunkwise(
            *(x[:, :, lo:hi] for x in (q, k, v, i_gate, f_gate)), state,
            chunk=hi - lo)
    states = tuple(torch.stack([st[i] for st in starts], dim=2)
                   for i in range(3))
    return states, state


def chunk_outputs_plain(q, k, v, i_gate, f_gate, states,
                        chunk: int = CHUNK) -> torch.Tensor:
    """Plain version of the outputs kernel -> y in q's dtype: every chunk's
    outputs from the state at its start (``chunk_states_plain``'s
    ``states``, C_c in float32 or bf16)."""
    from repro_torch.models import ssm

    s = q.shape[2]
    ys = []
    for c, lo in enumerate(range(0, s, chunk)):
        hi = min(lo + chunk, s)
        start = tuple(x[:, :, c].float() for x in states)
        y, _ = ssm.mlstm_chunkwise(
            *(x[:, :, lo:hi] for x in (q, k, v, i_gate, f_gate)), start,
            chunk=hi - lo)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _fn(name: str, n_ptr: int, n_int: int, n_ll: int, tail):
    fn = getattr(_build.library("mlstm_chunk"), name)
    fn.argtypes = ([_c_void_p] * n_ptr + [_c_int] * n_int + [_c_ll] * n_ll
                   + list(tail))
    fn.restype = _c_int
    return fn


@functools.cache
def _lib():
    return {"fp32": _fn("mlstm_chunk_launch", 12, 4, 18,
                        (_c_float, _c_void_p)),
            "states": _fn("mlstm_states_launch", 13, 4, 12, (_c_void_p,)),
            "outputs": _fn("mlstm_outputs_launch", 9, 4, 18,
                           (_c_float, _c_void_p))}


def _state_out(b: int, h: int, dh: int, dev) -> tuple:
    """The final state's buffers, three tensors of their own (a custom op's
    outputs alias nothing)."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((b, h, dh, dh), (b, h, dh), (b, h)))


def _y_out(q: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = q.shape
    return torch.empty((b, s, h, dh), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def mlstm_states_cuda(k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
                      f_gate: torch.Tensor, state=None):
    """Launch the bf16 states kernel -> (states, final) as
    ``chunk_states_plain``, C_c in bf16.  Inputs validated by ``ops``."""
    b, h, s, dh = k.shape
    dev = k.device
    n_chunks = -(-s // CHUNK)
    cs = torch.empty((b, h, n_chunks, dh, dh), dtype=torch.bfloat16,
                     device=dev)
    nm = torch.empty((b * h * n_chunks * (dh + 1),), dtype=torch.float32,
                     device=dev)
    ns = nm[:b * h * n_chunks * dh].view(b, h, n_chunks, dh)
    ms = nm[b * h * n_chunks * dh:].view(b, h, n_chunks)
    c1, n1, m1 = _state_out(b, h, dh, dev)
    c0, n0, m0 = (0, 0, 0) if state is None else (x.data_ptr() for x in state)
    status = _lib()["states"](
        k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
        c0, n0, m0, cs.data_ptr(), ns.data_ptr(), ms.data_ptr(),
        c1.data_ptr(), n1.data_ptr(), m1.data_ptr(), b, h, s, dh,
        *k.stride()[:3], *v.stride()[:3], *i_gate.stride(),
        *f_gate.stride(), _stream(dev))
    _build.check(status, "mlstm_chunk (states)")
    return (cs, ns, ms), (c1, n1, m1)


def mlstm_outputs_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_gate: torch.Tensor, f_gate: torch.Tensor,
                       states) -> torch.Tensor:
    """Launch the bf16 outputs kernel on ``mlstm_states_cuda``'s states ->
    y (B, H, S, Dh), a view of a (B, S, H, Dh) buffer."""
    b, h, s, dh = q.shape
    y = _y_out(q)
    cs, ns, ms = states
    status = _lib()["outputs"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), cs.data_ptr(), ns.data_ptr(), ms.data_ptr(),
        y.data_ptr(), b, h, s, dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *i_gate.stride(), *f_gate.stride(),
        *y.stride()[:3], 1.0 / math.sqrt(dh), _stream(q.device))
    _build.check(status, "mlstm_chunk (outputs)")
    return y


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_gate: torch.Tensor, f_gate: torch.Tensor, state=None):
    """Launch the CUDA kernels on the current stream -> (y, (C, n, m)):
    bfloat16 the states kernel then the outputs kernel, float32 the FMA
    kernel.  Inputs must already be validated (``ops.mlstm`` does it)."""
    if q.dtype == torch.bfloat16:
        states, final = mlstm_states_cuda(k, v, i_gate, f_gate, state)
        return mlstm_outputs_cuda(q, k, v, i_gate, f_gate, states), final
    b, h, s, dh = q.shape
    dev = q.device
    y = _y_out(q)
    c1, n1, m1 = _state_out(b, h, dh, dev)
    c0, n0, m0 = (0, 0, 0) if state is None else (x.data_ptr() for x in state)
    status = _lib()["fp32"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), y.data_ptr(), c0, n0, m0, c1.data_ptr(),
        n1.data_ptr(), m1.data_ptr(), b, h, s, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *i_gate.stride(), *f_gate.stride(), *y.stride()[:3], math.sqrt(dh),
        _stream(dev))
    _build.check(status, "mlstm_chunk")
    return y, (c1, n1, m1)
