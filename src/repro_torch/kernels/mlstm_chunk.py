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

The backward (``csrc/mlstm_chunk_bwd.cu``, four FMA kernels over chunks
of ``CHUNK``) reads what the forward saves when asked (``save``): the
state at every chunk's start (the bf16 path's scratch; the float32 kernel
writes it every 256 positions) and, per position, ell = m_t + log(den_t)
and sgn, the sign of N_t where |N_t| > exp(-m_t), else 0
(``chunk_stats_plain``).  Its plain versions, one per kernel, are
``chunk_scores_plain``, ``chunk_states_bwd_plain``, ``chunk_grads_plain``
and ``chunk_gates_bwd_plain``; composed they are ``mlstm_chunk_bwd_plain``
(the CPU body of the backward op), the gradient of
``mlstm_chunk_fwd_plain``'s y with every stabilizer held constant.
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


def chunk_stats_plain(q, k, i_gate, f_gate, states,
                      chunk: int = CHUNK) -> torch.Tensor:
    """Plain version of the forward kernels' per-position statistics ->
    (B, H, 2, S) float32: ell = m_t + log(den_t), the log of the
    normaliser with its stabilizer taken out, and sgn, sign(N_t) where
    |N_t| > exp(-m_t) (the branch of the max the gradient takes) and 0
    where the floor wins.  ``states`` are the chunk states of
    ``chunk_states_plain`` (only n_c and m_c are read)."""
    b, h, s, dh = q.shape
    _, ns, ms = states
    stats = torch.zeros((b, h, 2, s), dtype=torch.float32, device=q.device)
    for c, lo in enumerate(range(0, s, chunk)):
        hi = min(lo + chunk, s)
        bb, ii, m_t = _chunk_decays(i_gate, f_gate, ms[:, :, c], lo, hi)
        g = torch.exp(bb + ms[:, :, c, None] - m_t)
        qs = q[:, :, lo:hi].float() / math.sqrt(dh)
        w = (qs @ k[:, :, lo:hi].float().transpose(-1, -2)) * _decay_matrix(
            bb, ii, m_t)
        big_n = g * (qs @ ns[:, :, c, :, None])[..., 0] + w.sum(-1)
        floor = torch.exp(-m_t)
        den = torch.maximum(big_n.abs(), floor)
        stats[:, :, 0, lo:hi] = m_t + torch.log(den)
        stats[:, :, 1, lo:hi] = torch.where(big_n.abs() > floor,
                                            torch.sign(big_n), 0.0)
    return stats


def mlstm_chunk_fwd_plain(q, k, v, i_gate, f_gate, state=None,
                          chunk: int = CHUNK):
    """The forward with what its backward reads -> (y, (C, n, m), states,
    stats): ``mlstm_chunk_plain``'s y and final state, the float32 state
    at every ``chunk``'s start (``chunk_states_plain``) and the
    per-position statistics (``chunk_stats_plain``)."""
    y, final = mlstm_chunk_plain(q, k, v, i_gate, f_gate, state)
    states, _ = chunk_states_plain(q, k, v, i_gate, f_gate, state, chunk)
    return y, final, states, chunk_stats_plain(q, k, i_gate, f_gate, states,
                                               chunk)


# ---------------------------------------------------------------------------
# The backward: plain versions of the four kernels of csrc/mlstm_chunk_bwd.cu
# and their composition.  Every stabilizer (m_c, m_t, the next chunk's m)
# is held constant: y and the state times exp(m) do not depend on them.
# ---------------------------------------------------------------------------

N_AUX = 7             # per-position float32 scalars the scores kernel writes
AUX_B, AUX_I, AUX_M, AUX_G, AUX_INV_DEN, AUX_DN, AUX_KVW = range(N_AUX)
TILE = 64             # the backward kernels' position and head-dim tile


def _chunk_decays(i_gate, f_gate, m_c, lo: int, hi: int):
    """The chunk [lo, hi)'s b_t (in-chunk sums of log sigmoid(f)), i_t and
    m_t = max(b_t + m_c, max_{j<=t} b_t - b_j + i_j), clamped at -1e30,
    all float32 (B, H, hi - lo)."""
    from repro_torch.models import ssm

    bb = torch.cumsum(torch.nn.functional.logsigmoid(
        f_gate[:, :, lo:hi].float()), dim=-1)
    ii = i_gate[:, :, lo:hi].float()
    prefix = torch.cummax(ii - bb, dim=-1).values
    m_t = torch.clamp_min(torch.maximum(bb + m_c[..., None], bb + prefix),
                          ssm.NEG_INF)
    return bb, ii, m_t


def _decay_matrix(bb, ii, m_t) -> torch.Tensor:
    """E_tj = exp(b_t - b_j + i_j - m_t) for j <= t, else 0."""
    n = bb.shape[-1]
    tri = torch.ones((n, n), dtype=torch.bool, device=bb.device).tril()
    arg = (bb[..., :, None] - bb[..., None, :]) + ii[..., None, :] \
        - m_t[..., None]
    return torch.exp(torch.where(tri, arg, -torch.inf))


def _next_m(ms, m_last, c: int):
    return ms[:, :, c + 1] if c + 1 < ms.shape[2] else m_last


def chunk_scores_plain(q, k, v, i_gate, f_gate, y, dy, states, m_last,
                       stats, chunk: int = CHUNK):
    """Plain version of the scores kernel -> (aux (N_AUX, B, H, S), so
    (B, H, n_chunks), W, dS, G (B, H, n_chunks, chunk, chunk)), all
    float32.  Per position aux holds b_t, i_t, m_t, g_t, 1 / den_t (den_t
    = exp(ell_t - m_t)), dN_t = -sgn_t (dy_t . y_t) / den_t and kvw_t; per
    chunk so = exp(b_L + m_c - m'), m' the next chunk's m (``m_last``
    after the last).  Per chunk W = (q k^T / sqrt(Dh)) o E, dW = (dy v^T)
    / den_t + dN_t, G = dW o W and dS = dW o E, zero above the diagonal
    and past the sequence's end."""
    b, h, s, dh = q.shape
    n_chunks = -(-s // chunk)
    _, _, ms = states
    f32 = dict(dtype=torch.float32, device=q.device)
    aux = torch.zeros((N_AUX, b, h, s), **f32)
    so = torch.zeros((b, h, n_chunks), **f32)
    mats = torch.zeros((3, b, h, n_chunks, chunk, chunk), **f32)
    for c, lo in enumerate(range(0, s, chunk)):
        hi = min(lo + chunk, s)
        n = hi - lo
        m_c, m_next = ms[:, :, c], _next_m(ms, m_last, c)
        bb, ii, m_t = _chunk_decays(i_gate, f_gate, m_c, lo, hi)
        b_last = bb[..., -1]
        inv_den = torch.exp(m_t - stats[:, :, 0, lo:hi])
        dyc = dy[:, :, lo:hi].float()
        delta = (dyc * y[:, :, lo:hi].float()).sum(-1)
        aux[:, :, :, lo:hi] = torch.stack([
            bb, ii, m_t, torch.exp(bb + m_c[..., None] - m_t), inv_den,
            -stats[:, :, 1, lo:hi] * delta * inv_den,
            torch.exp((b_last[..., None] - bb) + ii - m_next[..., None])])
        so[:, :, c] = torch.exp(b_last + m_c - m_next)
        e = _decay_matrix(bb, ii, m_t)
        w = (q[:, :, lo:hi].float() @ k[:, :, lo:hi].float().transpose(
            -1, -2)) / math.sqrt(dh) * e
        dw = ((dyc @ v[:, :, lo:hi].float().transpose(-1, -2))
              * inv_den[..., None] + aux[AUX_DN, :, :, lo:hi, None])
        mats[0, :, :, c, :n, :n] = w
        mats[1, :, :, c, :n, :n] = torch.where(e > 0, dw * e, 0.0)
        mats[2, :, :, c, :n, :n] = torch.where(e > 0, dw * w, 0.0)
    return aux, so, mats[0], mats[1], mats[2]


def _tile_sums(x: torch.Tensor) -> torch.Tensor:
    """(..., Dh) -> (..., Dh / TILE): sums over each head-dim tile."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // TILE, TILE).sum(-1)


def chunk_states_bwd_plain(q, dy, aux, so, states, chunk: int = CHUNK):
    """Plain version of the reverse states kernel -> (dC (B, H, n_chunks,
    Dh, Dh), dn (B, H, n_chunks, Dh), p_part (B, H, n_chunks, (Dh /
    TILE)^2)), float32: the gradient of the state at every chunk's end
    (zero after the last) and, per chunk and (d, e) tile of C (tile index
    d + (Dh / TILE) e), the tile's share of <dC_end, C_c> (plus <dn_end,
    n_c> over its d-tile where e is the first tile)."""
    b, h, s, dh = q.shape
    n_chunks = so.shape[2]
    nt = dh // TILE
    cs, ns, _ = states
    f32 = dict(dtype=torch.float32, device=q.device)
    dcs = torch.zeros((b, h, n_chunks, dh, dh), **f32)
    dns = torch.zeros((b, h, n_chunks, dh), **f32)
    p_part = torch.zeros((b, h, n_chunks, nt * nt), **f32)
    dc = torch.zeros((b, h, dh, dh), **f32)
    dn = torch.zeros((b, h, dh), **f32)
    for c in reversed(range(n_chunks)):
        dcs[:, :, c], dns[:, :, c] = dc, dn
        prod = (dc * cs[:, :, c].float()).reshape(b, h, nt, TILE, nt, TILE)
        tiles = prod.sum((3, 5))                     # (b, h, d-tile, e-tile)
        tiles[..., 0] += _tile_sums(dn * ns[:, :, c])
        p_part[:, :, c] = tiles.transpose(-1, -2).reshape(b, h, nt * nt)
        if c == 0:
            break
        lo, hi = c * chunk, min((c + 1) * chunk, s)
        qg = (q[:, :, lo:hi].float() / math.sqrt(dh)
              * aux[AUX_G, :, :, lo:hi, None])
        dyy = dy[:, :, lo:hi].float() * aux[AUX_INV_DEN, :, :, lo:hi, None]
        dc = so[:, :, c, None, None] * dc + qg.transpose(-1, -2) @ dyy
        dn = so[:, :, c, None] * dn + (qg * aux[AUX_DN, :, :, lo:hi, None]
                                       ).sum(-2)
    return dcs, dns, p_part


def chunk_grads_plain(q, k, v, dy, aux, w, ds, states, dcs, dns,
                      chunk: int = CHUNK):
    """Plain version of the per-chunk gradient kernel -> (dq, dk, dv in
    q's dtype, r_part, q_part (B, H, S, Dh / TILE) float32):

      dq_t = [g_t (C_c dY_t + dN_t n_c) + sum_j dS_tj k_j] / sqrt(Dh)
      dk_j = sum_t dS_tj q~_t + kvw_j (dC v_j + dn)
      dv_j = sum_t W_tj dY_t + kvw_j dC^T k_j

    (dY_t = dy_t / den_t, q~ = q / sqrt(Dh), dC and dn at the chunk's
    end), and per head-dim tile the shares of q~_t . (C_c dY_t + dN_t n_c)
    (r_part) and of k_j . (dC v_j + dn) (q_part)."""
    b, h, s, dh = q.shape
    cs, ns, _ = states
    dq, dk, dv = (torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    r_part = torch.zeros((b, h, s, dh // TILE), **f32)
    q_part = torch.zeros((b, h, s, dh // TILE), **f32)
    for c, lo in enumerate(range(0, s, chunk)):
        hi = min(lo + chunk, s)
        n = hi - lo
        qs = q[:, :, lo:hi].float() / math.sqrt(dh)
        kc, vc = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        sc = aux[:, :, :, lo:hi, None]
        dyy = dy[:, :, lo:hi].float() * sc[AUX_INV_DEN]
        dense_q = (dyy @ cs[:, :, c].float().transpose(-1, -2)
                   + sc[AUX_DN] * ns[:, :, c, None])
        r_part[:, :, lo:hi] = _tile_sums(qs * dense_q)
        dsc, wc = ds[:, :, c, :n, :n], w[:, :, c, :n, :n]
        dq[:, :, lo:hi] = (sc[AUX_G] * dense_q + dsc @ kc) / math.sqrt(dh)
        dense_k = vc @ dcs[:, :, c].transpose(-1, -2) + dns[:, :, c, None]
        q_part[:, :, lo:hi] = _tile_sums(kc * dense_k)
        dk[:, :, lo:hi] = (sc[AUX_KVW] * dense_k
                           + dsc.transpose(-1, -2) @ qs)
        dv[:, :, lo:hi] = (sc[AUX_KVW] * (kc @ dcs[:, :, c])
                           + wc.transpose(-1, -2) @ dyy)
    return dq, dk, dv, r_part, q_part


def chunk_gates_bwd_plain(f_gate, aux, so, g_mat, r_part, q_part, p_part,
                          chunk: int = CHUNK):
    """Plain version of the gates kernel -> (di, df) in the gates' dtype.
    Per chunk, with R_t = g_t sum(r_part_t), Q_j = kvw_j sum(q_part_j), P
    = so sum(p_part):  di_j = sum_t G_tj + Q_j;  db_t = sum_j G_tj -
    sum_t' G_t't + R_t - Q_t, plus sum_j Q_j + P at the chunk's last
    position; d log f_u = sum_{t>=u} db_t;  df = d log f sigmoid(-f)."""
    b, h, s = f_gate.shape
    di = torch.empty((b, h, s), dtype=f_gate.dtype, device=f_gate.device)
    df = torch.empty_like(di)
    for c, lo in enumerate(range(0, s, chunk)):
        hi = min(lo + chunk, s)
        n = hi - lo
        gc = g_mat[:, :, c, :n, :n]
        col = gc.sum(-2)
        big_r = aux[AUX_G, :, :, lo:hi] * r_part[:, :, lo:hi].sum(-1)
        big_q = aux[AUX_KVW, :, :, lo:hi] * q_part[:, :, lo:hi].sum(-1)
        db = gc.sum(-1) - col + big_r - big_q
        db[..., -1] += big_q.sum(-1) + so[:, :, c] * p_part[:, :, c].sum(-1)
        dlogf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
        di[:, :, lo:hi] = col + big_q
        df[:, :, lo:hi] = dlogf * torch.sigmoid(-f_gate[:, :, lo:hi].float())
    return di, df


def mlstm_chunk_bwd_plain(q, k, v, i_gate, f_gate, y, states, m_last, stats,
                          dy, chunk: int = CHUNK):
    """The chunkwise mLSTM's backward -> (dq, dk, dv, di, df) in the inputs'
    dtypes, from the forward's y, chunk states (C_c, n_c, m_c at every
    ``chunk``'s start), final m and per-position statistics
    (``mlstm_chunk_fwd_plain``), and y's gradient dy: the four kernels'
    plain versions composed."""
    aux, so, w, ds, g_mat = chunk_scores_plain(q, k, v, i_gate, f_gate, y, dy,
                                               states, m_last, stats, chunk)
    dcs, dns, p_part = chunk_states_bwd_plain(q, dy, aux, so, states, chunk)
    dq, dk, dv, r_part, q_part = chunk_grads_plain(q, k, v, dy, aux, w, ds,
                                                   states, dcs, dns, chunk)
    di, df = chunk_gates_bwd_plain(f_gate, aux, so, g_mat, r_part, q_part,
                                   p_part, chunk)
    return dq, dk, dv, di, df


def _fn(lib: str, name: str, n_ptr: int, n_int: int, n_ll: int, tail,
        head=()):
    fn = getattr(_build.library(lib), name)
    fn.argtypes = (list(head) + [_c_void_p] * n_ptr + [_c_int] * n_int
                   + [_c_ll] * n_ll + list(tail))
    fn.restype = _c_int
    return fn


@functools.cache
def _lib():
    return {"fp32": _fn("mlstm_chunk", "mlstm_chunk_launch", 16, 4, 18,
                        (_c_float, _c_void_p)),
            "states": _fn("mlstm_chunk", "mlstm_states_launch", 13, 4, 12,
                          (_c_void_p,)),
            "outputs": _fn("mlstm_chunk", "mlstm_outputs_launch", 10, 4, 18,
                           (_c_float, _c_void_p))}


@functools.cache
def _bwd_lib():
    tail = (_c_float, _c_void_p)
    return {name: _fn("mlstm_chunk_bwd", f"mlstm_bwd_{name}_launch", n_ptr,
                      4, n_ll, tail if name != "gates" else (_c_void_p,),
                      head=(_c_int,))
            for name, n_ptr, n_ll in (("scores", 15, 21), ("states", 9, 6),
                                      ("grads", 16, 12), ("gates", 9, 3))}


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


def _ptrs(*xs) -> list:
    return [x.data_ptr() for x in xs]


def _strides(*xs) -> list:
    return [st for x in xs for st in x.stride()[:3]]


def _states_out(q: torch.Tensor) -> tuple:
    """Buffers of the state at every chunk's start (C_c in q's dtype, n_c,
    m_c float32), each a tensor of its own."""
    b, h, s, dh = q.shape
    n_chunks = -(-s // CHUNK)
    return (torch.empty((b, h, n_chunks, dh, dh), dtype=q.dtype,
                        device=q.device),
            *(torch.empty(shape, dtype=torch.float32, device=q.device)
              for shape in ((b, h, n_chunks, dh), (b, h, n_chunks))))


def _stats_out(q: torch.Tensor) -> torch.Tensor:
    b, h, s, _ = q.shape
    return torch.empty((b, h, 2, s), dtype=torch.float32, device=q.device)


def mlstm_states_cuda(k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
                      f_gate: torch.Tensor, state=None):
    """Launch the bf16 states kernel -> (states, final) as
    ``chunk_states_plain``, C_c in bf16.  Inputs validated by ``ops``."""
    b, h, s, dh = k.shape
    dev = k.device
    cs, ns, ms = _states_out(k)
    c1, n1, m1 = _state_out(b, h, dh, dev)
    c0, n0, m0 = (0, 0, 0) if state is None else (x.data_ptr() for x in state)
    status = _lib()["states"](
        k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
        c0, n0, m0, *_ptrs(cs, ns, ms, c1, n1, m1), b, h, s, dh,
        *_strides(k, v), *i_gate.stride(), *f_gate.stride(), _stream(dev))
    _build.check(status, "mlstm_chunk (states)")
    return (cs, ns, ms), (c1, n1, m1)


def mlstm_outputs_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_gate: torch.Tensor, f_gate: torch.Tensor,
                       states, stats: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Launch the bf16 outputs kernel on ``mlstm_states_cuda``'s states ->
    y (B, H, S, Dh), a view of a (B, S, H, Dh) buffer; it also writes the
    per-position statistics into ``stats`` (B, H, 2, S) where given."""
    b, h, s, dh = q.shape
    y = _y_out(q)
    status = _lib()["outputs"](
        *_ptrs(q, k, v, i_gate, f_gate, *states, y),
        0 if stats is None else stats.data_ptr(), b, h, s, dh,
        *_strides(q, k, v), *i_gate.stride(), *f_gate.stride(),
        *_strides(y), 1.0 / math.sqrt(dh), _stream(q.device))
    _build.check(status, "mlstm_chunk (outputs)")
    return y


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_gate: torch.Tensor, f_gate: torch.Tensor, state=None,
                     save: bool = False):
    """Launch the CUDA kernels on the current stream -> (y, (C, n, m)), and
    with ``save`` also the chunk states and the per-position statistics
    the backward reads (as ``mlstm_chunk_fwd_plain``, C_c in q's dtype):
    bfloat16 the states kernel then the outputs kernel, float32 the FMA
    kernel.  Inputs must already be validated (``ops.mlstm`` does it)."""
    if q.dtype == torch.bfloat16:
        states, final = mlstm_states_cuda(k, v, i_gate, f_gate, state)
        stats = _stats_out(q) if save else None
        y = mlstm_outputs_cuda(q, k, v, i_gate, f_gate, states, stats)
        return (y, final, states, stats) if save else (y, final)
    b, h, s, dh = q.shape
    dev = q.device
    y = _y_out(q)
    c1, n1, m1 = _state_out(b, h, dh, dev)
    c0, n0, m0 = (0, 0, 0) if state is None else (x.data_ptr() for x in state)
    saved = (*_states_out(q), _stats_out(q)) if save else None
    status = _lib()["fp32"](
        *_ptrs(q, k, v, i_gate, f_gate, y), c0, n0, m0,
        *_ptrs(c1, n1, m1), *(_ptrs(*saved) if save else (0,) * 4),
        b, h, s, dh, *_strides(q, k, v), *i_gate.stride(), *f_gate.stride(),
        *_strides(y), math.sqrt(dh), _stream(dev))
    _build.check(status, "mlstm_chunk")
    if save:
        return y, (c1, n1, m1), saved[:3], saved[3]
    return y, (c1, n1, m1)


# ---------------------------------------------------------------------------
# The backward's launchers: each kernel alone (the plain versions' twins,
# same arguments and outputs), and the four in order.
# ---------------------------------------------------------------------------

def _dtype_code(x: torch.Tensor) -> int:
    return 1 if x.dtype == torch.bfloat16 else 0


def mlstm_bwd_scores_cuda(q, k, v, i_gate, f_gate, y, dy, states, m_last,
                          stats):
    """The scores kernel -> as ``chunk_scores_plain``, but W, dS and G
    written only on the 64 x 64 tiles at or below each chunk's diagonal
    within its length (the rest of each stays as allocated)."""
    b, h, s, dh = q.shape
    n_chunks = -(-s // CHUNK)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    aux = torch.empty((N_AUX, b, h, s), **f32)
    so = torch.empty((b, h, n_chunks), **f32)
    # the kernel writes the 64 x 64 tiles at or below each chunk's
    # diagonal, within its length, and the other kernels read only those
    w, ds, g = (torch.empty((b, h, n_chunks, CHUNK, CHUNK), **f32)
                for _ in range(3))
    status = _bwd_lib()["scores"](
        _dtype_code(q), *_ptrs(q, k, v, i_gate, f_gate, y, dy),
        *_ptrs(states[2], m_last, stats, aux, so, w, ds, g), b, h, s, dh,
        *_strides(q, k, v), *i_gate.stride(), *f_gate.stride(),
        *_strides(y, dy), 1.0 / math.sqrt(dh), _stream(dev))
    _build.check(status, "mlstm_chunk_bwd (scores)")
    return aux, so, w, ds, g


def mlstm_bwd_states_cuda(q, dy, aux, so, states):
    """The reverse states kernel -> as ``chunk_states_bwd_plain``."""
    b, h, s, dh = q.shape
    n_chunks = so.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    dcs = torch.empty((b, h, n_chunks, dh, dh), **f32)
    dns = torch.empty((b, h, n_chunks, dh), **f32)
    p_part = torch.empty((b, h, n_chunks, (dh // TILE) ** 2), **f32)
    status = _bwd_lib()["states"](
        _dtype_code(q), *_ptrs(q, dy, aux, so, states[0], states[1], dcs,
                               dns, p_part), b, h, s, dh, *_strides(q, dy),
        1.0 / math.sqrt(dh), _stream(q.device))
    _build.check(status, "mlstm_chunk_bwd (states)")
    return dcs, dns, p_part


def mlstm_bwd_grads_cuda(q, k, v, dy, aux, w, ds, states, dcs, dns):
    """The per-chunk gradient kernel -> as ``chunk_grads_plain``."""
    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    r_part, q_part = (torch.empty((b, h, s, dh // TILE), dtype=torch.float32,
                                  device=q.device) for _ in range(2))
    status = _bwd_lib()["grads"](
        _dtype_code(q), *_ptrs(q, k, v, dy, aux, w, ds, states[0], states[1],
                               dcs, dns, dq, dk, dv, r_part, q_part),
        b, h, s, dh, *_strides(q, k, v, dy), 1.0 / math.sqrt(dh),
        _stream(q.device))
    _build.check(status, "mlstm_chunk_bwd (grads)")
    return dq, dk, dv, r_part, q_part


def mlstm_bwd_gates_cuda(f_gate, aux, so, g, r_part, q_part, p_part):
    """The gates kernel -> as ``chunk_gates_bwd_plain``."""
    b, h, s = f_gate.shape
    dh = r_part.shape[-1] * TILE
    di = torch.empty((b, h, s), dtype=f_gate.dtype, device=f_gate.device)
    df = torch.empty_like(di)
    status = _bwd_lib()["gates"](
        _dtype_code(f_gate), *_ptrs(f_gate, aux, so, g, r_part, q_part,
                                    p_part, di, df), b, h, s, dh,
        *f_gate.stride(), _stream(f_gate.device))
    _build.check(status, "mlstm_chunk_bwd (gates)")
    return di, df


def mlstm_chunk_bwd_cuda(q, k, v, i_gate, f_gate, y, states, m_last, stats,
                         dy):
    """Launch the four backward kernels on the current stream -> (dq, dk,
    dv, di, df), as ``mlstm_chunk_bwd_plain``.  q, k, v, y and dy with any
    (batch, head, position) strides and a contiguous head dim; the saved
    tensors as the forward op returns them."""
    states = tuple(x.contiguous() for x in states)
    m_last, stats = m_last.contiguous(), stats.contiguous()
    aux, so, w, ds, g = mlstm_bwd_scores_cuda(q, k, v, i_gate, f_gate, y, dy,
                                              states, m_last, stats)
    dcs, dns, p_part = mlstm_bwd_states_cuda(q, dy, aux, so, states)
    dq, dk, dv, r_part, q_part = mlstm_bwd_grads_cuda(q, k, v, dy, aux, w,
                                                      ds, states, dcs, dns)
    del dcs, w, ds
    di, df = mlstm_bwd_gates_cuda(f_gate, aux, so, g, r_part, q_part, p_part)
    return dq, dk, dv, di, df
