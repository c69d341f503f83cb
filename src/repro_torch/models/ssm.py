"""Recurrent sequence-mixing layers, the counterpart of ``repro.models.ssm``:
the depthwise causal conv, the selective SSM (Mamba-style, the Hymba
hybrid's SSM heads), the mLSTM cell (matrix memory) and the sLSTM cell
(scalar memory with exponential gating), each with a whole-sequence form
and an O(1)-state decode step.

  * selective SSM -- the diagonal recurrence h_t = a_t h_{t-1} + b_t over
    a sequence as a log-depth (Hillis-Steele) scan of the JAX package's
    ``combine``, ceil(log2 S) steps of whole-tensor ops; it rounds in
    another order than ``jax.lax.associative_scan`` (float32 products of
    decays <= 1: a few ulps apart).  The JAX package has no Pallas kernel
    for it, so neither has the port.
  * mLSTM over a sequence -- ``apply_mlstm`` hands q, k, v and the gates
    to ``kernels.ops.mlstm`` (the chunkwise kernel on a CUDA tensor,
    ``mlstm_chunkwise`` on a CPU one); one token goes through
    ``mlstm_step``.  ``mlstm_parallel`` is the quadratic oracle.
  * sLSTM -- sequential by construction: a Python loop of ``slstm_step``.

Decode steps carry (conv_state, ssm_state), (conv_state, C, n, m) and
(c, n, h, m).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
NEG_INF = -1e30   # the stabilizer's start and clamp


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Depthwise causal conv (the mLSTM block's front conv).
# ---------------------------------------------------------------------------

def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          state: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D), w (K,D) -> (y (B,S,D), new_state (B,K-1,D)).

    ``state`` holds the trailing K-1 inputs of the previous segment (decode)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    return y, xp[:, -(k - 1):, :]


# ---------------------------------------------------------------------------
# Selective SSM (Mamba-style) head block.
# ---------------------------------------------------------------------------

def init_ssm(gen: torch.Generator, cfg: ModelConfig, d_inner: int, *,
             device, dtype: torch.dtype = layers.F32) -> Params:
    """``dtype`` is that of the tensors the layer casts at use (projections,
    conv taps, dt bias, skip); ``a_log`` stays float32."""
    d, n = cfg.d_model, cfg.ssm_state
    kw = dict(device=device, dtype=dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    return {
        "w_in": layers.dense_init(gen, d, d_inner, **kw),
        "conv_w": layers._normal(gen, (cfg.ssm_conv, d_inner), device,
                                 lambda x: x * 0.2, dtype),
        "w_bc": layers.dense_init(gen, d_inner, 2 * n, **kw),
        "w_dt": layers.dense_init(gen, d_inner, d_inner, scale=0.01, **kw),
        "dt_bias": layers._uniform(
            gen, (d_inner,), device,
            lambda u: torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))),
            dtype),
        "a_log": (torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=device))[None, :]
                  * torch.ones((d_inner, 1), dtype=torch.float32,
                               device=device)),
        "d_skip": torch.ones((d_inner,), **kw),
        "w_out": layers.dense_init(gen, d_inner, d_inner, **kw),
    }


def _ssm_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + bx_t along axis 1.
    a, bx: (B, S, D, N) float32; ``h0`` (B, D, N) the state before the
    first step.  Hillis-Steele: after the step of stride 2^i, position t
    holds the combine of positions (t - 2^(i+1), t], so ceil(log2 S) steps
    of ``combine(left, right) = (a_l a_r, a_r b_l + b_r)``."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    s = a.shape[1]
    step = 1
    while step < s:
        b_new = a[:, step:] * bx[:, :-step] + bx[:, step:]
        a_new = a[:, :-step] * a[:, step:]
        bx = torch.cat([bx[:, :step], b_new], dim=1)
        a = torch.cat([a[:, :step], a_new], dim=1)
        step *= 2
    return bx


def apply_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig,
              conv_state: torch.Tensor | None = None,
              ssm_state: torch.Tensor | None = None):
    """x (B, S, d_model) -> (y (B, S, d_inner), conv_state, ssm_state).

    A whole sequence starts from zero states when they are None; a decode
    step passes both (S may be 1).  The new ssm state is float32."""
    dtype = x.dtype
    n = cfg.ssm_state
    xz = x @ p["w_in"].to(dtype)                                # (B,S,Di)
    xc, conv_state_new = causal_depthwise_conv(xz, p["conv_w"], conv_state)
    xc = F.silu(xc)
    bc = xc @ p["w_bc"].to(dtype)                               # (B,S,2N)
    b_in, c_out = bc[..., :n], bc[..., n:]
    dt = F.softplus(xc @ p["w_dt"].to(dtype) + p["dt_bias"].to(dtype))
    a = -torch.exp(p["a_log"].float())                          # (Di,N) < 0
    # discretize: a_bar = exp(dt A); b_bar x = dt B x
    a_bar = torch.exp(dt.float()[..., None] * a)                # (B,S,Di,N)
    bx = (dt * xc).float()[..., None] * b_in.float()[..., None, :]
    h = _ssm_scan(a_bar, bx, ssm_state)                         # (B,S,Di,N)
    y = torch.einsum("bsdn,bsn->bsd", h.to(dtype), c_out)
    y = y + xc * p["d_skip"].to(dtype)
    y = y * F.silu(xz)                                          # gated
    y = y @ p["w_out"].to(dtype)
    return y, conv_state_new, h[:, -1].float()


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell).
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, d_inner: int, *,
               device) -> Params:
    h = cfg.n_heads
    dh = d_inner // h
    return {
        # block-diagonal per-head qkv, (H, Dh, 3Dh), as in the JAX package
        "w_qkv": layers._normal(gen, (h, dh, 3 * dh), device,
                                lambda x: x / math.sqrt(dh)),
        "w_if": layers.dense_init(gen, d_inner, 2 * h, scale=0.01,
                                  device=device),
        "if_bias": torch.cat([_zeros((h,), device),
                              3.0 * torch.ones((h,), device=device)]),
        "o_norm": _zeros((dh,), device),
    }


def mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilized parallel mLSTM (the quadratic oracle).  q,k,v (B,H,S,Dh);
    gates (B,H,S) pre-activations -> (y (B,H,S,Dh), F (B,H,S), m (B,H,S))."""
    s, dh = q.shape[2], q.shape[3]
    logf = F.logsigmoid(f_gate.float())
    fcum = torch.cumsum(logf, dim=-1)
    dmat = (fcum[..., :, None] - fcum[..., None, :]
            + i_gate.float()[..., None, :])
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    dmat = torch.where(mask, dmat, -torch.inf)
    m = torch.clamp_min(torch.amax(dmat, dim=-1, keepdim=True), NEG_INF)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() / math.sqrt(dh)
    w = scores * dexp
    norm = torch.maximum(torch.abs(torch.sum(w, dim=-1, keepdim=True)),
                         torch.exp(-m))
    y = torch.einsum("bhst,bhtd->bhsd", (w / norm).to(v.dtype), v)
    return y, fcum, m[..., 0]


def zero_mlstm_state(b: int, h: int, dh: int, device):
    """(C, n, m) at the start of a sequence."""
    return (_zeros((b, h, dh, dh), device), _zeros((b, h, dh), device),
            torch.full((b, h), NEG_INF, dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM: S / L sequential steps over chunks of L,
    O(L^2) parallel work inside each; equal (up to rounding) to the
    parallel form for any L that divides S.

    q,k,v (B,H,S,Dh); gates (B,H,S); state (C, n, m) or None.  Returns
    (y in v's dtype, (C, n, m) float32 at the end).  The plain version of
    the ``mlstm_chunk`` kernel (``kernels.mlstm_chunk``)."""
    b, h, s, dh = q.shape
    if s % chunk:
        raise ValueError(f"mlstm_chunkwise: chunk {chunk} does not divide "
                         f"S = {s}")
    C, n, m = state if state is not None else zero_mlstm_state(b, h, dh,
                                                               q.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    ys = []
    for lo in range(0, s, chunk):
        qc, kc, vc = (x[:, :, lo:lo + chunk] for x in (q, k, v))
        ic, fc = i_gate[:, :, lo:lo + chunk], f_gate[:, :, lo:lo + chunk]
        logf = F.logsigmoid(fc.float())
        bcum = torch.cumsum(logf, dim=-1)                  # b_t
        icast = ic.float()
        # stabilizer per token: max(inter, intra)
        intra_arg = bcum[..., :, None] - bcum[..., None, :] + icast[..., None, :]
        intra_arg = torch.where(tri, intra_arg, -torch.inf)
        m_intra = torch.amax(intra_arg, dim=-1)            # (B,H,L)
        m_inter = bcum + m[..., None]
        m_t = torch.clamp_min(torch.maximum(m_inter, m_intra), NEG_INF)
        # inter-chunk contribution
        qf = qc.float() / math.sqrt(dh)
        g_inter = torch.exp(m_inter - m_t)                 # (B,H,L)
        y_inter = torch.matmul(qf, C) * g_inter[..., None]
        n_inter = torch.matmul(qf, n[..., None])[..., 0] * g_inter
        # intra-chunk contribution
        dexp = torch.exp(intra_arg - m_t[..., None])       # (B,H,L,L)
        kf, vf = kc.float(), vc.float()
        w = torch.matmul(qf, kf.transpose(-1, -2)) * dexp
        y_intra = torch.matmul(w, vf)
        n_intra = torch.sum(w, dim=-1)
        denom = torch.maximum(torch.abs(n_inter + n_intra),
                              torch.exp(-m_t))[..., None]
        ys.append(((y_inter + y_intra) / denom).to(vc.dtype))
        # state update to the chunk's end
        b_last = bcum[..., -1]
        m_new = torch.maximum(
            b_last + m,
            torch.amax(b_last[..., None] - bcum + icast, dim=-1))
        scale_old = torch.exp(b_last + m - m_new)
        kv_w = torch.exp(b_last[..., None] - bcum + icast - m_new[..., None])
        kw = kf * kv_w[..., None]                          # (B,H,L,Dh)
        C = scale_old[..., None, None] * C + torch.matmul(kw.transpose(-1, -2),
                                                          vf)
        n = scale_old[..., None] * n + torch.sum(kw, dim=-2)
        m = m_new
    return torch.cat(ys, dim=2), (C, n, m)


def mlstm_step(q, k, v, i_gate, f_gate, C, n, m):
    """One recurrent mLSTM step.  q,k,v (B,H,Dh); gates (B,H);
    C (B,H,Dh,Dh), n (B,H,Dh), m (B,H) -> (y in v's dtype, C, n, m)."""
    dh = q.shape[-1]
    logf = F.logsigmoid(f_gate.float())
    ig = i_gate.float()
    m_new = torch.maximum(logf + m, ig)
    f_sc = torch.exp(logf + m - m_new)[..., None, None]
    i_sc = torch.exp(ig - m_new)[..., None, None]
    kf, vf = k.float(), v.float()
    C_new = f_sc * C + i_sc * (kf[..., :, None] * vf[..., None, :])
    n_new = f_sc[..., 0] * n + i_sc[..., 0] * kf
    qf = q.float() / math.sqrt(dh)
    num = torch.matmul(qf[..., None, :], C_new)[..., 0, :]
    den = torch.maximum(torch.abs(torch.sum(n_new * qf, dim=-1, keepdim=True)),
                        torch.exp(-m_new)[..., None])
    return (num / den).to(v.dtype), C_new, n_new, m_new


def apply_mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig, d_inner: int,
                state: tuple | None = None):
    """x (B,S,Di) -> (y (B,S,Di), new_state).  state = (C, n, m).  A whole
    sequence (S > 1) goes through ``ops.mlstm`` on transposed views of the
    projections; one token through ``mlstm_step``."""
    dtype = x.dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    dh = d_inner // h
    xh = x.reshape(b, s, h, dh)
    qkv = torch.einsum("bshd,hde->bshe", xh, p["w_qkv"].to(dtype))
    q, k, v = torch.split(qkv, dh, dim=-1)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2) / math.sqrt(dh)
    v = v.transpose(1, 2)
    gates = x @ p["w_if"].to(dtype) + p["if_bias"].to(dtype)
    i_gate = gates[..., :h].transpose(1, 2)                # (B,H,S)
    f_gate = gates[..., h:].transpose(1, 2)

    if s > 1:
        y, new_state = ops.mlstm(q, k, v, i_gate, f_gate, state)
    else:
        C, n, m = state if state is not None else zero_mlstm_state(
            b, h, dh, x.device)
        y, C, n, m = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                i_gate[:, :, 0], f_gate[:, :, 0], C, n, m)
        y = y[:, :, None]
        new_state = (C, n, m)

    y = layers.rms_norm(y, p["o_norm"])
    y = y.transpose(1, 2).reshape(b, s, h * dh)
    return y, new_state


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell) -- sequential.
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig, d_inner: int, *,
               device) -> Params:
    h = cfg.n_heads
    dh = d_inner // h
    return {
        "w_zifo": layers.dense_init(gen, d_inner, 4 * d_inner, device=device),
        "r_zifo": layers._normal(gen, (h, dh, 4 * dh), device,
                                 lambda x: x / math.sqrt(dh)),
        "b_zifo": _zeros((4 * d_inner,), device),
        "o_norm": _zeros((dh,), device),
    }


def slstm_step(p: Params, xt: torch.Tensor, state, cfg: ModelConfig,
               d_inner: int):
    """xt (B, 4*Di) preactivation from the input projection; state (c,n,h,m)
    each (B,H,Dh).  Head-blocked recurrent weights (block-diagonal R)."""
    c, n, hid, m = state
    b = xt.shape[0]
    nh = cfg.n_heads
    dh = d_inner // nh
    rec = torch.einsum("bhd,hde->bhe", hid, p["r_zifo"].to(hid.dtype))
    pre = (xt.reshape(b, nh, 4 * dh) + rec
           + p["b_zifo"].reshape(nh, 4 * dh).to(xt.dtype))
    z, i_raw, f_raw, o = torch.split(pre.float(), dh, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    # log sigmoid as min(f, 0) - log1p(exp(-|f|)) (the kernels' form):
    # F.logsigmoid fails on CUDA tensors under two nested vmaps (a round
    # of co-training vmaps over services, then clients)
    logf = torch.minimum(f_raw, torch.zeros_like(f_raw)) - torch.log1p(
        torch.exp(-f_raw.abs()))
    m_new = torch.maximum(logf + m, i_raw)
    i_sc = torch.exp(i_raw - m_new)
    f_sc = torch.exp(logf + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, h_new.to(xt.dtype), m_new)


def zero_slstm_state(b: int, h: int, dh: int, dtype, device):
    """(c, n, h, m) at the start of a sequence; h in the compute dtype."""
    return (_zeros((b, h, dh), device), _zeros((b, h, dh), device),
            torch.zeros((b, h, dh), dtype=dtype, device=device),
            torch.full((b, h, dh), NEG_INF, dtype=torch.float32,
                       device=device))


def apply_slstm(p: Params, x: torch.Tensor, cfg: ModelConfig, d_inner: int,
                state=None):
    """x (B,S,Di) -> (y (B,S,Di), state).  Sequential over S."""
    dtype = x.dtype
    b, s, _ = x.shape
    nh = cfg.n_heads
    dh = d_inner // nh
    if state is None:
        state = zero_slstm_state(b, nh, dh, dtype, x.device)
    xin = x @ p["w_zifo"].to(dtype)                        # (B,S,4Di)
    hs = []
    for t in range(s):
        state = slstm_step(p, xin[:, t], state, cfg, d_inner)
        hs.append(state[2])
    y = torch.stack(hs, dim=1)                             # (B,S,H,Dh)
    y = layers.rms_norm(y, p["o_norm"]).reshape(b, s, nh * dh)
    return y, state
