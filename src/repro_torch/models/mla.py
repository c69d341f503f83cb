"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the
counterpart of ``repro.models.mla``.

Queries go through a low-rank bottleneck (q_lora_rank); keys/values are
compressed into a single latent c_kv of dim kv_lora_rank plus one shared
RoPE key head of dim rope_head_dim.  The decode cache stores only
(c_kv, k_rope).  Per-head dims: qk = head_dim (nope part) + rope_head_dim;
v = v_head_dim.

Both paths are PyTorch ops, as the JAX package computes them with jnp (no
Pallas kernel): qk 192 / v 128 (expanded) and 576 / 512 (absorbed) fall
outside the attention kernels' head dims.  With a cache and at most 4 new
tokens the absorbed path attends in latent space; otherwise the cache (or
the sequence) is expanded to per-head k and v.  The cache is written in
place; attention reads its filled part only (the JAX package masks the
unwritten tail, which adds exact zeros).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import api as dist_api
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict
ABSORB_MAX_TOKENS = 4   # a cached call with at most this many tokens absorbs


def init_mla(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype: torch.dtype = layers.F32) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    qk_nope, qk_rope, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kw = dict(device=device, dtype=dtype)
    zeros = dict(dtype=torch.float32, device=device)
    return {
        "wq_a": layers.dense_init(gen, d, cfg.q_lora_rank, **kw),
        "q_a_norm": torch.zeros((cfg.q_lora_rank,), **zeros),
        "wq_b": layers.dense_init(gen, cfg.q_lora_rank,
                                  h * (qk_nope + qk_rope), **kw),
        "wkv_a": layers.dense_init(gen, d, cfg.kv_lora_rank + qk_rope, **kw),
        "kv_a_norm": torch.zeros((cfg.kv_lora_rank,), **zeros),
        "wkv_b": layers.dense_init(gen, cfg.kv_lora_rank, h * (qk_nope + dv),
                                   **kw),
        "wo": layers.dense_init(gen, h * dv, d, **kw),
    }


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h, qk_nope, qk_rope = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    dtype = x.dtype
    q = layers.rms_norm(x @ p["wq_a"].to(dtype), p["q_a_norm"])
    q = (q @ p["wq_b"].to(dtype)).reshape(b, s, h, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _compress_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x -> (c_kv (B,S,R), k_rope (B,S,1,Dr)) -- exactly what the cache
    stores."""
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = layers.rms_norm(c_kv, p["kv_a_norm"])
    k_rope = layers.apply_rope(k_rope[:, :, None, :], positions,
                               cfg.rope_theta)
    return c_kv, k_rope


def _expand_kv(p: Params, c_kv: torch.Tensor, cfg: ModelConfig):
    """latent (B,S,R) -> k_nope (B,S,H,Dn), v (B,S,H,Dv) via the
    up-projection."""
    b, s, _ = c_kv.shape
    h, qk_nope, dv = cfg.n_heads, cfg.head_dim, cfg.v_head_dim
    kv = (c_kv @ p["wkv_b"].to(c_kv.dtype)).reshape(b, s, h, qk_nope + dv)
    return kv[..., :qk_nope], kv[..., qk_nope:]


def apply_mla(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, *,
              cache_ckv: torch.Tensor | None = None,    # (B, Smax, R)
              cache_krope: torch.Tensor | None = None,  # (B, Smax, Dr)
              cache_len: int = 0,
              chunk_size: int = 1024) -> torch.Tensor:
    """-> out (B, S, d).

    Without a cache: the full sequence.  With one: the new tokens are
    written into it at ``cache_len`` (in place) and attention runs against
    the filled part, absorbed into latent space when S <= 4."""
    b, s, _ = x.shape
    dtype = x.dtype
    h, qk_nope, qk_rope, dv = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                               cfg.v_head_dim)
    q = _project_q(p, x, cfg, positions)
    c_kv_new, k_rope_new = _compress_kv(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)

    if cache_ckv is None:
        c_kv_all, k_rope_all = c_kv_new, k_rope_new[:, :, 0]
        kv_valid, q_offset = None, 0
    else:
        end = cache_len + s
        if end > cache_ckv.shape[1]:
            raise ValueError(f"cache of {cache_ckv.shape[1]} positions "
                             f"cannot take {cache_len} + {s}")
        cache_ckv[:, cache_len:end] = c_kv_new
        cache_krope[:, cache_len:end] = k_rope_new[:, :, 0]
        c_kv_all, k_rope_all = cache_ckv[:, :end], cache_krope[:, :end]
        kv_valid, q_offset = end, cache_len

    if cache_ckv is not None and s <= ABSORB_MAX_TOKENS:
        # ---- absorbed path: fold wkv_b into the query and output sides --
        #   q_nope^T k_nope = (q_nope W_UK)^T c_kv ;  out = (P c_kv) W_UV
        w_kv = p["wkv_b"].to(dtype).reshape(cfg.kv_lora_rank, h,
                                            qk_nope + dv)
        w_uk, w_uv = w_kv[..., :qk_nope], w_kv[..., qk_nope:]
        q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)   # (B,s,H,R)
        # the float32 caches pinned to (batch over data, replicated): the
        # layout the JAX model pins them to
        c_kv_att = dist_api.constrain(c_kv_all.float(), "batch", None, None)
        k_rope_att = dist_api.constrain(k_rope_all.float(), "batch", None,
                                        None)
        logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv_att)
                  + torch.einsum("bshn,btn->bhst", q_rope.float(),
                                 k_rope_att)) * scale
        mask = layers.make_attention_mask(
            s, c_kv_all.shape[1], q_offset=q_offset, causal=True,
            kv_valid_len=kv_valid, device=x.device)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out_lat = torch.einsum("bhst,btr->bshr", probs, c_kv_att).to(dtype)
        out = torch.einsum("bshr,rhn->bshn", out_lat, w_uv)    # (B,s,H,Dv)
        return out.reshape(b, s, h * dv) @ p["wo"].to(dtype)

    k_nope, v = _expand_kv(p, c_kv_all, cfg)
    k = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(
        *k_nope.shape[:3], qk_rope)], dim=-1)
    out = layers.chunked_attention(
        q, k, v, causal=True, q_offset=q_offset, kv_valid_len=kv_valid,
        scale=scale, chunk_size=chunk_size)
    return out.reshape(b, s, h * dv) @ p["wo"].to(dtype)
