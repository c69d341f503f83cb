"""Decoder-only transformer, the counterpart of ``repro.models.transformer``
for the dense family.

The layer stack is a Python loop over a list of per-layer parameter dicts
(the JAX package scans over stacked parameters; ``interop`` converts).
Whether a layer is global is a Python bool, so each layer hands the
attention kernels a static ``window``.  Attention goes through
``kernels.ops``:

  * a whole sequence (no cache, or prefill into an empty cache) runs the
    flash-attention kernel on the fresh q, k, v: causal, with the sliding
    window on local layers;
  * one decode token runs the decode kernel against the cache, filled up
    to and including the new token; on a local layer whose filled length
    exceeds the window, the kernel gets the window's slice of the cache
    (a view, read through its strides), which is exactly the JAX mask
    ``q_pos - kv_pos < window`` at ``q_pos = cache_len``.

The KV cache holds the compute dtype and is updated in place (JAX returns
new arrays); its ``"len"`` is a host int, as the serving loop knows it.
MoE, MLA, hybrid, the int8 KV cache, M-RoPE, logit soft-capping and the
parallel block raise "not yet ported".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, check_ported

Params = dict[str, Any]

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed",
             "unembed", "bq", "bk", "bv")


# ---------------------------------------------------------------------------
# Single-layer init / apply.
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, *, device) -> Params:
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=device)
    p: Params = {
        "ln1": torch.zeros((d,), **zeros),
        "attn": layers.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, device=device),
    }
    if cfg.d_ff > 0:
        p["ln2"] = torch.zeros((d,), **zeros)
        p["ffn"] = layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind,
                                   device=device)
    if cfg.post_norm:
        p["ln_post_attn"] = torch.zeros((d,), **zeros)
        p["ln_post_ffn"] = torch.zeros((d,), **zeros)
    return p


def _attend(p: Params, cfg: ModelConfig, h: torch.Tensor,
            positions: torch.Tensor, window: int,
            cache_k: torch.Tensor | None, cache_v: torch.Tensor | None,
            cache_len: int) -> torch.Tensor:
    """GQA attention of one layer -> (B, S, Hq, D).  With a cache, k and v
    are written into it in place at [cache_len, cache_len + S)."""
    dtype = h.dtype
    s = h.shape[1]
    q, k, v = layers.project_qkv(p, h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, dtype)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if cache_k is not None:
        cache_k[:, cache_len:cache_len + s] = k
        cache_v[:, cache_len:cache_len + s] = v
    if cache_k is None or cache_len == 0:
        # (B, S, H, D) -> (B, H, S, D) views, no copy: the kernel reads
        # strides and writes its output in q's layout
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window)
        return out.transpose(1, 2)
    if s != 1:
        raise NotImplementedError("appending more than one token to a "
                                  "non-empty cache is not yet ported")
    lo = cache_len + 1 - window if 0 < window < cache_len + 1 else 0
    out = ops.attention_decode(q[:, 0], cache_k[:, lo:cache_len + 1],
                               cache_v[:, lo:cache_len + 1],
                               cache_len + 1 - lo)
    return out[:, None]


def apply_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int,
                cache_k: torch.Tensor | None = None,
                cache_v: torch.Tensor | None = None,
                cache_len: int = 0) -> torch.Tensor:
    """One dense block (pre-norm, optional gemma3 post-norms)."""
    dtype = x.dtype
    b, s = x.shape[:2]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    raw = _attend(p["attn"], cfg, h, positions, window, cache_k, cache_v,
                  cache_len)
    attn_out = (raw.reshape(b, s, cfg.n_heads * cfg.head_dim)
                @ p["attn"]["wo"].to(dtype))
    if cfg.post_norm:
        attn_out = layers.rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    if "ffn" not in p:
        return x + attn_out
    x_mid = x + attn_out
    ffn_in = layers.rms_norm(x_mid, p["ln2"], cfg.norm_eps)
    ffn_out = layers.apply_mlp(p["ffn"], ffn_in, cfg.mlp_kind, dtype)
    if cfg.post_norm:
        ffn_out = layers.rms_norm(ffn_out, p["ln_post_ffn"], cfg.norm_eps)
    return x_mid + ffn_out


# ---------------------------------------------------------------------------
# The full model.
# ---------------------------------------------------------------------------

def _generator(seed: int | torch.Generator) -> torch.Generator:
    """The init's generator: ``seed`` itself, or a CPU generator seeded
    with it.  The CPU's stream and a card's differ for one seed, so the
    weights are drawn on the CPU and copied to their device."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


@dataclasses.dataclass(frozen=True)
class CausalLM:
    cfg: ModelConfig

    def __post_init__(self):
        check_ported(self.cfg)
        if self.cfg.family == "ssm":
            raise ValueError(f"{self.cfg.name}: the ssm family is XLSTMLM's "
                             f"(models/xlstm.py), not CausalLM's")

    # ---------------- init ----------------
    def init(self, seed: int | torch.Generator, *,
             device="cuda") -> Params:
        """float32 parameters on ``device``, drawn on the CPU from a
        generator seeded with ``seed`` (or ``seed`` itself), so one seed
        gives the same weights on every device; ``device="meta"`` gives
        shapes only."""
        cfg = self.cfg
        gen = _generator(seed)
        p: Params = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       device=device),
            "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             device=device)
        p["blocks"] = [init_layer(gen, cfg, device=device)
                       for _ in range(cfg.n_layers)]
        return p

    def cast_params(self, params: Params) -> Params:
        """The same tree with every matrix and bias (the tensors the layers
        cast at use) already in the compute dtype: identical values, cast
        once instead of at every call.  Norm scales stay float32, as the
        layers read them in float32."""
        dt = self.cfg.compute_dtype

        def cast(tree):
            if isinstance(tree, list):
                return [cast(x) for x in tree]
            return {key: (cast(x) if isinstance(x, (dict, list))
                          else x.to(dt) if key in _MATRICES else x)
                    for key, x in tree.items()}

        return cast(params)

    # ---------------- caches ----------------
    def init_cache(self, batch_size: int, max_len: int, *,
                   device="cuda") -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        k = torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
        return {"len": 0, "k": k, "v": torch.zeros_like(k)}

    # ---------------- forward ----------------
    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                cache: dict | None = None,
                logits_mode: str = "all") -> tuple[torch.Tensor, dict | None]:
        """Returns (logits, new_cache).  The cache's k and v are updated in
        place; the returned dict carries the new length."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, s = tokens.shape
        x = params["embed"][tokens].to(dt)
        if cfg.embed_scale:
            # sqrt(d) in float32, rounded to the compute dtype before the
            # product (bf16: sqrt(1152) = 33.94 -> 34.0), as in JAX
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                                 device=x.device).to(dt)
        cache_len = 0 if cache is None else int(cache["len"])
        if cache is not None and cache_len + s > cache["k"].shape[2]:
            raise ValueError(f"cache of {cache['k'].shape[2]} positions "
                             f"cannot take {cache_len} + {s}")
        if positions is None:
            positions = torch.arange(cache_len, cache_len + s,
                                     device=tokens.device)
            positions = positions[None, :].expand(b, s)

        for i, p_l in enumerate(params["blocks"]):
            window = 0 if cfg.is_global_layer(i) else cfg.sliding_window
            x = apply_layer(
                p_l, cfg, x, positions, window=window,
                cache_k=None if cache is None else cache["k"][i],
                cache_v=None if cache is None else cache["v"][i],
                cache_len=cache_len)

        x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        table = params.get("unembed")
        if table is None:
            logits = x @ params["embed"].to(dt).T
        else:
            logits = x @ table.to(dt)
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "len": cache_len + s}
        return logits, new_cache

    # ---------------- public entry points ----------------
    def prefill(self, params: Params, batch: dict, max_len: int):
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], max_len,
                                device=tokens.device)
        return self.forward(params, tokens, positions=batch.get("positions"),
                            cache=cache, logits_mode="last")

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor | None = None):
        return self.forward(params, tokens, positions=positions, cache=cache,
                            logits_mode="last")
