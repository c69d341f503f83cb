"""Shared neural-network layers, the counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors, made by ``init_*`` functions from a
``torch.Generator`` and consumed by the matching ``apply`` functions.  All
layers take an explicit compute ``dtype``: params are stored in float32 and
cast at use (``.to(dtype)`` is a no-op on a tensor already in it).

Conventions (the JAX package's):
  * activations: (batch, seq, d_model)
  * attention heads: q (B, S, Hq, Dh); k/v (B, S, Hkv, Dh) with Hq % Hkv == 0
  * weights: (in_features, out_features) so forward is x @ w

``make_attention_mask``, ``attention`` and ``chunked_attention`` are plain
PyTorch: the model's attention goes through ``kernels.ops`` (the
flash-attention and decode kernels); these serve as test oracles.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers.
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape: tuple[int, ...], device,
            op: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
            ) -> torch.Tensor:
    """float32 standard normals of ``shape`` drawn on ``gen``'s device (the
    CPU: ``transformer._generator``), ``op`` applied there, then moved to
    ``device``, one tensor at a time: the same values on every device.
    ``device="meta"`` draws nothing."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return op(x).to(device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device) -> torch.Tensor:
    s = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return _normal(gen, (d_in, d_out), device, lambda x: x * s)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, *,
               device) -> torch.Tensor:
    return _normal(gen, (vocab, d_model), device, lambda x: x * 0.02)


# ---------------------------------------------------------------------------
# Normalization.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """float32 math, ``1 + scale``, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., dim//2), float32."""
    half = dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exponent)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotates the full head dim as two
    halves (not interleaved pairs)."""
    d = x.shape[-1]
    cos, sin = _rope_angles(positions, d, theta)      # (B, S, D/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain oracles).
# ---------------------------------------------------------------------------

def make_attention_mask(q_len: int, kv_len: int, q_offset: int = 0,
                        causal: bool = True, window: int = 0,
                        kv_valid_len: int | None = None,
                        device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask.  ``q_offset`` is the absolute position of
    the first query (decode: the cache length); ``window`` > 0 keeps the
    last ``window`` positions; ``kv_valid_len`` masks the unwritten tail of
    a KV cache."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= q_pos - kv_pos < window
    if kv_valid_len is not None:
        mask &= kv_pos < kv_valid_len
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None, *,
              scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention.  q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) ->
    (B,Sq,Hq,D).  Softmax in float32; the probabilities are cast to v's
    dtype before the second product, as in the JAX package."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * s
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, v.shape[-1])


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_valid_len: int | None = None,
                      scale: float | None = None,
                      chunk_size: int = 1024) -> torch.Tensor:
    """Query-chunked attention: O(chunk * S_kv) score memory.  Unlike the
    JAX version, a query length that is not a multiple of ``chunk_size``
    is allowed (the last chunk is short)."""
    sq = q.shape[1]
    outs = []
    for lo in range(0, sq, chunk_size):
        hi = min(sq, lo + chunk_size)
        mask = make_attention_mask(hi - lo, k.shape[1], q_offset + lo, causal,
                                   window, kv_valid_len, device=q.device)
        outs.append(attention(q[:, lo:hi], k, v, mask, scale=scale))
    return torch.cat(outs, dim=1)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   qk_norm: bool = False, device) -> Params:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, device=device),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, device=device),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, device=device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, device=device),
    }
    zeros = dict(dtype=torch.float32, device=device)
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), **zeros)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), **zeros)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), **zeros)
    if qk_norm:
        p["q_norm"] = torch.zeros((head_dim,), **zeros)
        p["k_norm"] = torch.zeros((head_dim,), **zeros)
    return p


def project_qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                head_dim: int, dtype: torch.dtype
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", *, device) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d_model, d_ff, device=device),
            "w_up": dense_init(gen, d_model, d_ff, device=device),
            "w_down": dense_init(gen, d_ff, d_model, device=device),
        }
    return {  # plain gelu MLP
        "w_up": dense_init(gen, d_model, d_ff, device=device),
        "w_down": dense_init(gen, d_ff, d_model, device=device),
    }


def apply_mlp(p: Params, x: torch.Tensor, kind: str,
              dtype: torch.dtype) -> torch.Tensor:
    """``geglu`` and ``gelu`` use the tanh-approximate GELU
    (``jax.nn.gelu(approximate=True)``)."""
    if kind == "swiglu":
        act = F.silu(x @ p["w_gate"].to(dtype))
        return (act * (x @ p["w_up"].to(dtype))) @ p["w_down"].to(dtype)
    if kind == "geglu":
        act = F.gelu(x @ p["w_gate"].to(dtype), approximate="tanh")
        return (act * (x @ p["w_up"].to(dtype))) @ p["w_down"].to(dtype)
    if kind == "gelu":
        return (F.gelu(x @ p["w_up"].to(dtype), approximate="tanh")
                @ p["w_down"].to(dtype))
    raise ValueError(kind)
