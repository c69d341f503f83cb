"""Encoder-decoder transformer (the Seamless-M4T-v2 backbone), the
counterpart of ``repro.models.encdec``.

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d_model).  The decoder is a causal transformer with
cross-attention; its cache holds the decoder self-attention k and v plus
the cross-attention k and v, projected once from the encoder output at
prefill (``k``, ``v``, ``xk``, ``xv``: the JAX layout, layers first).

Attention goes through ``kernels.ops``: the encoder's self-attention and
the decoder's cross-attention over a whole sequence run the flash kernel
without the causal mask (the cross-attention with Sq target positions
against Skv = S_src source ones), the decoder's self-attention over the
prompt runs it causally; at decode the self-attention and the
cross-attention each run the decode kernel, the latter with ``valid_len``
= S_src.  The cache is updated in place; its ``"len"`` is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.distributed import api as dist_api
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _generator, cast_tree

Params = dict[str, Any]


def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig, *, device,
                       dtype: torch.dtype = layers.F32) -> Params:
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=device)
    kw = dict(device=device, dtype=dtype)
    return {
        "ln1": torch.zeros((d,), **zeros),
        "attn": layers.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, **kw),
        "ln2": torch.zeros((d,), **zeros),
        "ffn": layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, **kw),
    }


def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, *, device,
                       dtype: torch.dtype = layers.F32) -> Params:
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=device)
    kw = dict(device=device, dtype=dtype)
    return {
        "ln1": torch.zeros((d,), **zeros),
        "self_attn": layers.init_attention(gen, d, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim, **kw),
        "ln_x": torch.zeros((d,), **zeros),
        "cross_attn": layers.init_attention(gen, d, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.head_dim,
                                            **kw),
        "ln2": torch.zeros((d,), **zeros),
        "ffn": layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, **kw),
    }


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return (x @ w.to(x.dtype)).reshape(*x.shape[:2], n, dh)


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) attention output -> (B, S, d) through ``wo``."""
    return o.reshape(*o.shape[:2], -1) @ p["wo"].to(o.dtype)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """(B, S, H, D) tensors through the flash kernel on transposed views."""
    return ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class Seq2SeqLM:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.name}: Seq2SeqLM runs the encdec "
                             f"family, not {self.cfg.family!r}")

    # ---------------- init ----------------
    def init(self, seed: int | torch.Generator, *, device="cuda",
             dtype: torch.dtype | None = None) -> Params:
        """As ``CausalLM.init``: float32, or every matrix in ``dtype`` as
        it is drawn (bit for bit ``cast_params(init(...))``)."""
        cfg = self.cfg
        gen = _generator(seed)
        kw = dict(device=device, dtype=dtype or layers.F32)
        zeros = dict(dtype=torch.float32, device=device)
        return {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
            "enc_blocks": [init_encoder_layer(gen, cfg, **kw)
                           for _ in range(cfg.n_encoder_layers)],
            "dec_blocks": [init_decoder_layer(gen, cfg, **kw)
                           for _ in range(cfg.n_layers)],
            "ln_enc": torch.zeros((cfg.d_model,), **zeros),
            "ln_f": torch.zeros((cfg.d_model,), **zeros),
        }

    def cast_params(self, params: Params) -> Params:
        return cast_tree(params, self.cfg.compute_dtype)

    # ---------------- encoder ----------------
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_src, d_model) stub frontend embeddings."""
        cfg = self.cfg
        h_, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        x = frames.to(cfg.compute_dtype)
        b, s_src = x.shape[:2]
        pos = torch.arange(s_src, device=x.device)[None].expand(b, s_src)
        for p_l in params["enc_blocks"]:
            h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            a = p_l["attn"]
            q = layers.apply_rope(_heads(h, a["wq"], h_, dh), pos,
                                  cfg.rope_theta)
            k = layers.apply_rope(_heads(h, a["wk"], hkv, dh), pos,
                                  cfg.rope_theta)
            v = _heads(h, a["wv"], hkv, dh)
            x = x + _out(a, _flash(q, k, v, causal=False))
            h2 = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = x + layers.apply_mlp(p_l["ffn"], h2, cfg.mlp_kind, x.dtype)
        return layers.rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # ---------------- decoder ----------------
    def _decode_stack(self, params: Params, x: torch.Tensor,
                      enc_out: torch.Tensor | None,
                      cache: dict | None) -> torch.Tensor:
        """x: (B, S, d) target activations; ``enc_out`` (B, S_src, d), or
        None when the cross k and v come from the cache (decode).  With a
        cache, its slices are written in place."""
        cfg = self.cfg
        h_, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b, s = x.shape[:2]
        cache_len = 0 if cache is None else int(cache["len"])
        end = cache_len + s
        if cache is not None and cache_len and s != 1:
            raise NotImplementedError("appending more than one token to a "
                                      "non-empty cache is not yet ported")
        pos_q = torch.arange(cache_len, end, device=x.device)[None].expand(
            b, s)
        for i, p_l in enumerate(params["dec_blocks"]):
            h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            a = p_l["self_attn"]
            q = layers.apply_rope(_heads(h, a["wq"], h_, dh), pos_q,
                                  cfg.rope_theta)
            k = layers.apply_rope(_heads(h, a["wk"], hkv, dh), pos_q,
                                  cfg.rope_theta)
            v = _heads(h, a["wv"], hkv, dh)
            if cache is not None:
                cache["k"][i, :, cache_len:end] = k
                cache["v"][i, :, cache_len:end] = v
            if cache is None or cache_len == 0:
                o = _flash(q, k, v, causal=True)
            else:
                o = ops.attention_decode(q[:, 0], cache["k"][i, :, :end],
                                         cache["v"][i, :, :end], end)[:, None]
            x = x + _out(a, o)

            hx = layers.rms_norm(x, p_l["ln_x"], cfg.norm_eps)
            c = p_l["cross_attn"]
            q = _heads(hx, c["wq"], h_, dh)
            if enc_out is not None:
                # a whole sequence: project the cross k and v (no RoPE)
                xk = _heads(enc_out, c["wk"], hkv, dh)
                xv = _heads(enc_out, c["wv"], hkv, dh)
                if cache is not None:
                    cache["xk"][i].copy_(xk)
                    cache["xv"][i].copy_(xv)
                o = _flash(q, xk, xv, causal=False)
            else:
                xk, xv = cache["xk"][i], cache["xv"][i]
                o = ops.attention_decode(q[:, 0], xk, xv,
                                         xk.shape[1])[:, None]
            x = x + _out(c, o)
            h2 = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = x + layers.apply_mlp(p_l["ffn"], h2, cfg.mlp_kind, x.dtype)
        return x

    # ---------------- caches ----------------
    def init_cache(self, batch_size: int, max_len: int, src_len: int, *,
                   device="cuda") -> dict:
        cfg = self.cfg
        dt = cfg.compute_dtype
        lb = (cfg.n_layers, batch_size)
        kshape = (*lb, max_len, cfg.n_kv_heads, cfg.head_dim)
        xshape = (*lb, src_len, cfg.n_kv_heads, cfg.head_dim)
        z = dict(dtype=dt, device=device)
        return {"len": 0,
                "k": torch.zeros(kshape, **z), "v": torch.zeros(kshape, **z),
                "xk": torch.zeros(xshape, **z), "xv": torch.zeros(xshape, **z)}

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        x = dist_api.constrain(x, "batch", None, None)
        return dist_api.constrain(x @ params["embed"].to(x.dtype).T,
                                  "batch", None, "vocab")

    # ---------------- public entry points ----------------
    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        enc_out = self.encode(params, batch["frontend_embeds"])
        x = params["embed"][batch["tokens"]].to(self.cfg.compute_dtype)
        x = self._decode_stack(params, x, enc_out, None)
        return layers.softmax_cross_entropy(self._logits(params, x),
                                            batch["labels"],
                                            batch.get("loss_mask"))

    def prefill(self, params: Params, batch: dict, max_len: int):
        """Encodes the source, projects the cross k and v, and runs the
        target prompt.  Returns (last logits (B, 1, V), cache)."""
        frames, tokens = batch["frontend_embeds"], batch["tokens"]
        b, s = tokens.shape
        enc_out = self.encode(params, frames)
        cache = self.init_cache(b, max_len, frames.shape[1],
                                device=tokens.device)
        if s > max_len:
            raise ValueError(f"cache of {max_len} positions cannot take {s}")
        x = params["embed"][tokens].to(self.cfg.compute_dtype)
        x = self._decode_stack(params, x, enc_out, cache)
        return self._logits(params, x[:, -1:]), {**cache, "len": s}

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor | None = None):
        """One token a sequence; ``positions`` is unused (RoPE positions
        follow the cache length), as in the JAX package."""
        cache_len = int(cache["len"])
        if cache_len + tokens.shape[1] > cache["k"].shape[2]:
            raise ValueError(f"cache of {cache['k'].shape[2]} positions "
                             f"cannot take {cache_len} + {tokens.shape[1]}")
        x = params["embed"][tokens].to(self.cfg.compute_dtype)
        x = self._decode_stack(params, x, None, cache)
        return (self._logits(params, x[:, -1:]),
                {**cache, "len": cache_len + tokens.shape[1]})

    def forward(self, params, tokens, **kw):  # API parity with the JAX model
        raise NotImplementedError("use loss/prefill/decode_step for enc-dec")
