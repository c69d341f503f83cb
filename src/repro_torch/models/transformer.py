"""Decoder-only transformer, the counterpart of ``repro.models.transformer``:
the dense, MoE, MLA-MoE and hybrid (attention parallel to an SSM) families.

The layer stack is a Python loop over one list of per-layer parameter
dicts (the JAX package scans over stacked parameters, in ``"pairs"`` of
(dense, MoE) layers when ``moe_every == 2`` and as ``"lead"`` dense then
all-MoE ``"blocks"`` otherwise; ``interop`` interleaves them into the
list).  Whether a layer is global or MoE is a Python bool, so each layer
hands the attention kernels a static ``window``.  Attention goes through
``kernels.ops``:

  * a whole sequence (no cache, or prefill into an empty cache) runs the
    flash-attention kernel on the fresh q, k, v: causal, with the sliding
    window on local layers and the logit soft cap;
  * one decode token runs the decode kernel against the cache, filled up
    to and including the new token; on a local layer whose filled length
    exceeds the window, the kernel gets the window's slice of the cache
    (a view, read through its strides), which is exactly the JAX mask
    ``q_pos - kv_pos < window`` at ``q_pos = cache_len``;
  * with the int8 KV cache both attend over the dequantized k and v, as
    the JAX package does (prefill too: the quantized prompt, not the
    fresh one);
  * MLA (``models/mla.py``) and the MoE dispatch (``models/moe.py``) are
    PyTorch ops, as the JAX package computes them outside any kernel.

The cache is updated in place (JAX returns new arrays); its ``"len"`` is
a host int, as the serving loop knows it.  M-RoPE configs need (3, B, S)
positions: without them ``layers.apply_mrope`` raises, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed import api as dist_api
from repro_torch.kernels import ops
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
MOE_AUX_COEF = 0.01

# The tensors the layers cast to the compute dtype at use (so casting them
# once changes no value); everything else -- norm scales, ``a_log`` -- is
# read in float32.
_MATRICES = frozenset((
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up", "w_down",
    "embed", "unembed", "router", "wq_a", "wq_b", "wkv_a", "wkv_b", "w_in",
    "conv_w", "w_bc", "w_dt", "dt_bias", "d_skip", "w_out", "w_mix_out"))


def cast_tree(tree, dt: torch.dtype):
    """``tree`` with every tensor keyed in ``_MATRICES`` cast to ``dt``."""
    if isinstance(tree, list):
        return [cast_tree(x, dt) for x in tree]
    return {key: (cast_tree(x, dt) if isinstance(x, (dict, list))
                  else x.to(dt) if key in _MATRICES else x)
            for key, x in tree.items()}


# ---------------------------------------------------------------------------
# Single-layer init / apply.
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, use_moe: bool, *,
               device, dtype: torch.dtype = layers.F32) -> Params:
    """One block's parameters; ``dtype`` is that of its matrices."""
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=device)
    kw = dict(device=device, dtype=dtype)
    p: Params = {"ln1": torch.zeros((d,), **zeros)}
    if cfg.family == "mla_moe":
        p["attn"] = mla.init_mla(gen, cfg, **kw)
    else:
        p["attn"] = layers.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
    if cfg.family == "hybrid":
        # the hybrid mixes through w_mix_out; attn's wo is carried unused,
        # as in the JAX package
        d_inner = cfg.n_heads * cfg.head_dim
        p["ssm"] = ssm.init_ssm(gen, cfg, d_inner, **kw)
        p["attn_out_norm"] = torch.zeros((d_inner,), **zeros)
        p["ssm_out_norm"] = torch.zeros((d_inner,), **zeros)
        p["w_mix_out"] = layers.dense_init(gen, d_inner, d, **kw)
    if cfg.d_ff > 0 or use_moe:
        p["ln2"] = torch.zeros((d,), **zeros)
        if use_moe:
            p["ffn"] = moe.init_moe(gen, cfg, **kw)
        else:
            p["ffn"] = layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, **kw)
    if cfg.post_norm:
        p["ln_post_attn"] = torch.zeros((d,), **zeros)
        p["ln_post_ffn"] = torch.zeros((d,), **zeros)
    return p


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,S,H,D) -> (int8 values, per-(token, head) float32 scales).  Round
    half to even (``torch.round``), as ``jnp.round``."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(scale, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _attend(p: Params, cfg: ModelConfig, h: torch.Tensor,
            positions: torch.Tensor, window: int, cache: dict | None,
            cache_len: int) -> torch.Tensor:
    """GQA attention of one layer -> (B, S, Hq, D).  ``cache`` holds the
    layer's slices (``k``, ``v``; with int8 also ``k_scale``, ``v_scale``):
    k and v are written into it in place at [cache_len, cache_len + S)."""
    dtype = h.dtype
    s = h.shape[1]
    q, k, v = layers.project_qkv(p, h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, dtype)
    if cfg.mrope_sections:
        q = layers.apply_mrope(q, positions, cfg.mrope_sections,
                               cfg.rope_theta)
        k = layers.apply_mrope(k, positions, cfg.mrope_sections,
                               cfg.rope_theta)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    softcap = cfg.logit_softcap
    if cache is None:
        # (B, S, H, D) -> (B, H, S, D) views, no copy: the kernel reads
        # strides and writes its output in q's layout
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    end = cache_len + s
    if cache_len and s != 1:
        raise NotImplementedError("appending more than one token to a "
                                  "non-empty cache is not yet ported")
    # decode reads the window's slice; prefill all keys (the kernel masks)
    lo = end - window if cache_len and 0 < window < end else 0
    if "k_scale" in cache:
        k_q, k_s = _quantize_kv(k)
        v_q, v_s = _quantize_kv(v)
        cache["k"][:, cache_len:end] = k_q
        cache["v"][:, cache_len:end] = v_q
        cache["k_scale"][:, cache_len:end] = k_s
        cache["v_scale"][:, cache_len:end] = v_s
        k_all = _dequantize_kv(cache["k"][:, lo:end],
                               cache["k_scale"][:, lo:end], dtype)
        v_all = _dequantize_kv(cache["v"][:, lo:end],
                               cache["v_scale"][:, lo:end], dtype)
    else:
        cache["k"][:, cache_len:end] = k
        cache["v"][:, cache_len:end] = v
        k_all, v_all = cache["k"][:, lo:end], cache["v"][:, lo:end]
    if cache_len == 0:
        # prefill: the prompt's keys, fresh or (int8) dequantized
        if "k_scale" not in cache:
            k_all, v_all = k, v
        out = ops.attention(q.transpose(1, 2), k_all.transpose(1, 2),
                            v_all.transpose(1, 2), causal=True,
                            window=window, softcap=softcap)
        return out.transpose(1, 2)
    out = ops.attention_decode(q[:, 0], k_all, v_all, end - lo,
                               softcap=softcap)
    return out[:, None]


def apply_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, use_moe: bool, window: int,
                cache: dict | None = None, cache_len: int = 0,
                chunk_size: int = 1024
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """One block -> (x, MoE aux loss: a float32 scalar tensor, or 0.0 for a
    dense block, which launches nothing for it).  ``cache`` holds this
    layer's slices of the cache, updated in place."""
    dtype = x.dtype
    b, s = x.shape[:2]
    aux = 0.0
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)

    if cfg.family == "mla_moe":
        attn_out = mla.apply_mla(
            p["attn"], h, cfg, positions,
            cache_ckv=None if cache is None else cache["ckv"],
            cache_krope=None if cache is None else cache["krope"],
            cache_len=cache_len, chunk_size=chunk_size)
    elif cfg.family == "hybrid":
        d_inner = cfg.n_heads * cfg.head_dim
        a_out = _attend(p["attn"], cfg, h, positions, window, cache,
                        cache_len).reshape(b, s, d_inner)
        s_out, conv_st, ssm_st = ssm.apply_ssm(
            p["ssm"], h, cfg, None if cache is None else cache["conv"],
            None if cache is None else cache["ssm"])
        if cache is not None:
            cache["conv"].copy_(conv_st)
            cache["ssm"].copy_(ssm_st)
        mixed = 0.5 * (layers.rms_norm(a_out, p["attn_out_norm"], cfg.norm_eps)
                       + layers.rms_norm(s_out, p["ssm_out_norm"],
                                         cfg.norm_eps))
        attn_out = mixed @ p["w_mix_out"].to(dtype)
    else:
        raw = _attend(p["attn"], cfg, h, positions, window, cache, cache_len)
        attn_out = (raw.reshape(b, s, cfg.n_heads * cfg.head_dim)
                    @ p["attn"]["wo"].to(dtype))

    if cfg.post_norm:
        attn_out = layers.rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    if "ffn" not in p:
        return x + attn_out, aux
    if cfg.parallel_block:
        ffn_in, x_mid = h, x
    else:
        x_mid = x + attn_out
        ffn_in = layers.rms_norm(x_mid, p["ln2"], cfg.norm_eps)
    if use_moe:
        ffn_out, aux = moe.apply_moe(p["ffn"], ffn_in, cfg)
    else:
        ffn_out = layers.apply_mlp(p["ffn"], ffn_in, cfg.mlp_kind, dtype)
    if cfg.post_norm:
        ffn_out = layers.rms_norm(ffn_out, p["ln_post_ffn"], cfg.norm_eps)
    if cfg.parallel_block:
        return x + attn_out + ffn_out, aux
    return x_mid + ffn_out, aux


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
        if self.cfg.family in ("ssm", "encdec"):
            raise ValueError(f"{self.cfg.name}: the {self.cfg.family} family "
                             f"is not CausalLM's (registry.build_model)")
        if self.cfg.n_experts and self.cfg.moe_every == 2 and \
                self.cfg.n_layers % 2:
            raise ValueError(f"{self.cfg.name}: (dense, MoE) pairs need an "
                             f"even layer count, got {self.cfg.n_layers}")

    def moe_layers(self) -> list[bool]:
        """Which layers are MoE, as the JAX init builds them: odd layers of
        (dense, MoE) pairs when ``moe_every == 2``, else every layer past
        the ``n_dense_leading`` dense ones."""
        cfg = self.cfg
        if not cfg.n_experts:
            return [False] * cfg.n_layers
        if cfg.moe_every == 2:
            return [i % 2 == 1 for i in range(cfg.n_layers)]
        return [i >= cfg.n_dense_leading for i in range(cfg.n_layers)]

    # ---------------- init ----------------
    def init(self, seed: int | torch.Generator, *, device="cuda",
             dtype: torch.dtype | None = None) -> Params:
        """Parameters on ``device``, drawn from a generator seeded with
        ``seed`` (a CPU one: one seed gives the same weights on every
        device), or from ``seed`` itself when it is a generator.  float32,
        or with ``dtype`` every matrix cast to it as soon as it is drawn:
        bit for bit ``cast_params(init(...))`` of the compute dtype,
        without a float32 copy of the model.  ``device="meta"`` gives
        shapes only."""
        cfg = self.cfg
        gen = _generator(seed)
        kw = dict(device=device, dtype=dtype or layers.F32)
        p: Params = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
            "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             **kw)
        p["blocks"] = [init_layer(gen, cfg, use_moe, **kw)
                       for use_moe in self.moe_layers()]
        return p

    def cast_params(self, params: Params) -> Params:
        """The same tree with every matrix and bias (the tensors the layers
        cast at use) already in the compute dtype: identical values, cast
        once instead of at every call.  Norm scales (and the SSM's
        ``a_log``) stay float32, as the layers read them in float32."""
        return cast_tree(params, self.cfg.compute_dtype)

    # ---------------- caches ----------------
    def init_cache(self, batch_size: int, max_len: int, *,
                   device="cuda") -> dict:
        """The JAX package's cache, per family: ``ckv``/``krope`` (MLA);
        int8 ``k``/``v`` with float32 ``k_scale``/``v_scale``; compute-dtype
        ``k``/``v``; plus ``conv``/``ssm`` for the hybrid."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        lb = (cfg.n_layers, batch_size)
        cache: dict = {"len": 0}
        if cfg.family == "mla_moe":
            cache["ckv"] = torch.zeros((*lb, max_len, cfg.kv_lora_rank),
                                       dtype=dt, device=device)
            cache["krope"] = torch.zeros((*lb, max_len, cfg.rope_head_dim),
                                         dtype=dt, device=device)
        else:
            shape = (*lb, max_len, cfg.n_kv_heads, cfg.head_dim)
            kv_dt = (torch.int8 if cfg.kv_cache_dtype == "int8"
                     and cfg.family != "hybrid" else dt)
            cache["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
            cache["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
            if kv_dt == torch.int8:
                cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                               device=device)
                cache["v_scale"] = torch.zeros_like(cache["k_scale"])
        if cfg.family == "hybrid":
            d_inner = cfg.n_heads * cfg.head_dim
            cache["conv"] = torch.zeros((*lb, cfg.ssm_conv - 1, d_inner),
                                        dtype=dt, device=device)
            cache["ssm"] = torch.zeros((*lb, d_inner, cfg.ssm_state),
                                       dtype=torch.float32, device=device)
        return cache

    # ---------------- forward ----------------
    def forward_aux(self, params: Params, tokens: torch.Tensor,
                    positions: torch.Tensor | None = None,
                    cache: dict | None = None,
                    embeds_override: torch.Tensor | None = None,
                    logits_mode: str = "all", chunk_size: int = 1024
                    ) -> tuple[torch.Tensor, dict | None,
                               torch.Tensor | float]:
        """Returns (logits, new_cache, MoE aux loss summed over the layers:
        0.0 without MoE layers).  The cache's tensors are updated in place;
        the returned dict carries the new length.  ``embeds_override`` (B,
        P, d), the stub frontend's patch embeddings, replaces the first P
        positions' token embeddings."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, s = tokens.shape
        x = params["embed"][tokens].to(dt)
        if cfg.embed_scale:
            # sqrt(d) in float32, rounded to the compute dtype before the
            # product (bf16: sqrt(1152) = 33.94 -> 34.0), as in JAX
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                                 device=x.device).to(dt)
        if embeds_override is not None:
            n_pre = embeds_override.shape[1]
            x = torch.cat([embeds_override.to(dt), x[:, n_pre:]], dim=1)
        cache_len = 0 if cache is None else int(cache["len"])
        if cache is not None:
            room = (cache["ckv"] if cfg.family == "mla_moe"
                    else cache["k"]).shape[2]
            if cache_len + s > room:
                raise ValueError(f"cache of {room} positions cannot take "
                                 f"{cache_len} + {s}")
        if positions is None:
            positions = torch.arange(cache_len, cache_len + s,
                                     device=tokens.device)
            positions = positions[None, :].expand(b, s)

        aux = 0.0
        for i, (p_l, use_moe) in enumerate(zip(params["blocks"],
                                               self.moe_layers())):
            window = 0 if cfg.is_global_layer(i) else cfg.sliding_window
            c_l = None if cache is None else {
                key: val[i] for key, val in cache.items() if key != "len"}
            x, aux_l = apply_layer(p_l, cfg, x, positions, use_moe=use_moe,
                                   window=window, cache=c_l,
                                   cache_len=cache_len, chunk_size=chunk_size)
            aux = aux + aux_l

        x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        x = dist_api.constrain(x, "batch", None, None)
        table = params.get("unembed")
        if table is None:
            logits = x @ params["embed"].to(dt).T
        else:
            logits = x @ table.to(dt)
        # the canonical (batch over data, vocab over model) logits layout
        logits = dist_api.constrain(logits, "batch", None, "vocab")
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "len": cache_len + s}
        return logits, new_cache, aux

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                cache: dict | None = None,
                embeds_override: torch.Tensor | None = None,
                logits_mode: str = "all") -> tuple[torch.Tensor, dict | None]:
        """``forward_aux`` without the aux loss: (logits, new_cache)."""
        logits, new_cache, _ = self.forward_aux(
            params, tokens, positions, cache, embeds_override, logits_mode)
        return logits, new_cache

    # ---------------- public entry points ----------------
    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        logits, _, aux = self.forward_aux(
            params, batch["tokens"], positions=batch.get("positions"),
            embeds_override=batch.get("frontend_embeds"))
        ce = layers.softmax_cross_entropy(logits, batch["labels"],
                                          batch.get("loss_mask"))
        return ce + MOE_AUX_COEF * aux

    def prefill(self, params: Params, batch: dict, max_len: int):
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], max_len,
                                device=tokens.device)
        return self.forward(params, tokens, positions=batch.get("positions"),
                            cache=cache,
                            embeds_override=batch.get("frontend_embeds"),
                            logits_mode="last")

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor | None = None):
        return self.forward(params, tokens, positions=positions, cache=cache,
                            logits_mode="last")
