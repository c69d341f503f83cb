"""xLSTM language model (arXiv:2405.04517), the counterpart of
``repro.models.xlstm``: a stack of mLSTM blocks (matrix memory,
chunkwise-parallel) with one sLSTM block (scalar memory, sequential) every
``slstm_every`` blocks.

Block wiring follows the paper:
  * mLSTM block: pre-norm -> up-projection x2 (value + gate lanes) -> short
    causal conv on the value lane -> mLSTM -> silu-gate -> down-projection.
  * sLSTM block: pre-norm -> sLSTM (head-blocked recurrence) -> residual,
    then a GeGLU FFN sub-block at projection factor 4/3.

Blocks come in super-blocks of (slstm_every - 1) mLSTM + 1 sLSTM.  The JAX
package scans over parameters stacked on (n_super, n_mlstm); here
``params["m_blocks"]`` is a list of n_super lists of block dicts and
``params["s_blocks"]`` a list of n_super dicts, walked by Python loops
(``interop.xlstm_params_from_arrays`` converts).

A whole sequence (prefill, or the no-cache forward) runs each mLSTM layer
through the ``mlstm_chunk`` kernel (``kernels.ops.mlstm``); a decode step
runs ``ssm.mlstm_step`` and ``ssm.slstm_step``, as the JAX model does.  The
recurrent cache keeps the JAX layout (``m_C`` (n_super, n_m, B, H, Dh, Dh)
float32, and so on) and is updated in place, layer by layer; its ``"len"``
is a host int.  ``loss`` differentiates through the kernel's backward
(``ops.MLSTMChunk``) on the card and its plain version on the CPU; the
sLSTM is PyTorch ops on both.  ``remat`` has no counterpart; the logits
are pinned with ``distributed.api.constrain``, as in the JAX model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed import api as dist_api
from repro_torch.models import layers, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _generator

Params = dict[str, Any]

_NORMS = ("ln", "ln_ffn", "ln_f", "o_norm")   # read in float32 by rms_norm


def _ffn_dim(d: int) -> int:
    return ((4 * d // 3) + 63) // 64 * 64


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, *,
                     device) -> Params:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    return {
        "ln": torch.zeros((d,), dtype=torch.float32, device=device),
        "w_up": layers.dense_init(gen, d, 2 * d_inner, device=device),
        "conv_w": layers._normal(gen, (cfg.ssm_conv, d_inner), device,
                                 lambda x: x * 0.2),
        "cell": ssm.init_mlstm(gen, cfg, d_inner, device=device),
        "w_down": layers.dense_init(gen, d_inner, d, device=device),
    }


def apply_mlstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      state=None):
    """state = (conv_state, C, n, m) or None (no cache)."""
    dtype = x.dtype
    d_inner = cfg.ssm_expand * cfg.d_model
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"].to(dtype)
    a, g = up[..., :d_inner], up[..., d_inner:]
    conv_state = None if state is None else state[0]
    a, conv_state_new = ssm.causal_depthwise_conv(a, p["conv_w"], conv_state)
    a = F.silu(a)
    cell_state = None if state is None else state[1:]
    y, cell_state_new = ssm.apply_mlstm(p["cell"], a, cfg, d_inner, cell_state)
    y = y * F.silu(g)
    out = x + y @ p["w_down"].to(dtype)
    if state is None:
        return out, None
    return out, (conv_state_new, *cell_state_new)


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, *,
                     device) -> Params:
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), **zeros),
        "cell": ssm.init_slstm(gen, cfg, d, device=device),
        "ln_ffn": torch.zeros((d,), **zeros),
        "ffn": layers.init_mlp(gen, d, _ffn_dim(d), "geglu", device=device),
    }


def apply_slstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      state=None):
    dtype = x.dtype
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    y, state_new = ssm.apply_slstm(p["cell"], h, cfg, cfg.d_model, state)
    x = x + y
    h2 = layers.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    x = x + layers.apply_mlp(p["ffn"], h2, "geglu", dtype)
    return x, state_new


def _write(dst: tuple, src: tuple) -> None:
    """Copy a layer's new recurrent state into its cache slots, in place."""
    for buf, val in zip(dst, src):
        buf.copy_(val)


@dataclasses.dataclass(frozen=True)
class XLSTMLM:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "ssm":
            raise ValueError(f"{self.cfg.name}: XLSTMLM runs the ssm family, "
                             f"not {self.cfg.family!r}")

    @property
    def _layout(self) -> tuple[int, int]:
        """(n_super_blocks, mlstm_per_super)."""
        cfg = self.cfg
        if cfg.slstm_every <= 0:
            return 1, cfg.n_layers
        if cfg.n_layers % cfg.slstm_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"super-blocks of {cfg.slstm_every}")
        return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1

    # ---------------- init ----------------
    def init(self, seed: int | torch.Generator, *, device="cuda",
             dtype: torch.dtype | None = None) -> Params:
        """float32 parameters on ``device``, drawn on the CPU from a
        generator seeded with ``seed`` (or ``seed`` itself), so one seed
        gives the same weights on every device; ``device="meta"`` gives
        shapes only.  With ``dtype`` (the compute dtype) each block is cast
        as ``cast_params`` casts it as soon as it is drawn: the same tree
        as ``cast_params(init(...))``, bit for bit."""
        cfg = self.cfg
        n_super, n_m = self._layout
        gen = _generator(seed)
        cast = (lambda tree: tree) if dtype is None else (
            lambda tree: self._cast(tree, dtype))
        p: Params = {
            "embed": cast(layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            device=device)),
            "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device),
        }
        p["m_blocks"] = [[cast(init_mlstm_block(gen, cfg, device=device))
                          for _ in range(n_m)] for _ in range(n_super)]
        if cfg.slstm_every > 0:
            p["s_blocks"] = [cast(init_slstm_block(gen, cfg, device=device))
                             for _ in range(n_super)]
        if not cfg.tie_embeddings:
            p["unembed"] = cast(layers.dense_init(
                gen, cfg.d_model, cfg.vocab_size, device=device))
        return p

    def cast_params(self, params: Params) -> Params:
        """The same tree with every tensor but the norm scales in the compute
        dtype: the JAX model casts each of them to it at use (weights, gate
        biases, conv taps, recurrent matrices), so the values are the same,
        cast once.  Norm scales stay float32, as ``rms_norm`` reads them."""
        return self._cast(params, self.cfg.compute_dtype)

    @staticmethod
    def _cast(tree, dt: torch.dtype, key=None):
        if isinstance(tree, list):
            return [XLSTMLM._cast(x, dt) for x in tree]
        if isinstance(tree, dict):
            return {k: XLSTMLM._cast(x, dt, k) for k, x in tree.items()}
        return tree if key in _NORMS else tree.to(dt)

    # ---------------- caches ----------------
    def init_cache(self, batch_size: int, max_len: int, *,
                   device="cuda") -> dict:
        """The recurrent state of every layer at the start of a sequence, in
        the JAX layout.  ``max_len`` is unused: the state does not grow."""
        cfg = self.cfg
        n_super, n_m = self._layout
        d_inner = cfg.ssm_expand * cfg.d_model
        h = cfg.n_heads
        dh_m = d_inner // h
        dh_s = cfg.d_model // h
        dt = cfg.compute_dtype
        f32 = dict(dtype=torch.float32, device=device)
        lead = (n_super, n_m, batch_size)
        cache = {
            "len": 0,
            "m_conv": torch.zeros((*lead, cfg.ssm_conv - 1, d_inner),
                                  dtype=dt, device=device),
            "m_C": torch.zeros((*lead, h, dh_m, dh_m), **f32),
            "m_n": torch.zeros((*lead, h, dh_m), **f32),
            "m_m": torch.full((*lead, h), ssm.NEG_INF, **f32),
        }
        if cfg.slstm_every > 0:
            shape = (n_super, batch_size, h, dh_s)
            cache.update(
                s_c=torch.zeros(shape, **f32), s_n=torch.zeros(shape, **f32),
                s_h=torch.zeros(shape, dtype=dt, device=device),
                s_m=torch.full(shape, ssm.NEG_INF, **f32))
        return cache

    # ---------------- forward ----------------
    def _stack_forward(self, params: Params, x: torch.Tensor,
                       cache: dict | None) -> torch.Tensor:
        cfg = self.cfg
        n_super, n_m = self._layout
        for si in range(n_super):
            for li in range(n_m):
                st = None if cache is None else tuple(
                    cache[key][si, li] for key in ("m_conv", "m_C", "m_n",
                                                   "m_m"))
                x, new = apply_mlstm_block(params["m_blocks"][si][li], cfg, x,
                                           st)
                if cache is not None:
                    _write(st, new)
            if cfg.slstm_every > 0:
                st = None if cache is None else tuple(
                    cache[key][si] for key in ("s_c", "s_n", "s_h", "s_m"))
                x, new = apply_slstm_block(params["s_blocks"][si], cfg, x, st)
                if cache is not None:
                    _write(st, new)
        return x

    def forward(self, params: Params, tokens: torch.Tensor,
                cache: dict | None = None,
                logits_mode: str = "all") -> tuple[torch.Tensor, dict | None]:
        """Returns (logits, new_cache).  The cache's states are updated in
        place; the returned dict carries the new length."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = params["embed"][tokens].to(dt)
        x = self._stack_forward(params, x, cache)
        x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        x = dist_api.constrain(x, "batch", None, None)
        table = params.get("unembed")
        if table is None:
            logits = x @ params["embed"].to(dt).T
        else:
            logits = x @ table.to(dt)
        logits = dist_api.constrain(logits, "batch", None, "vocab")
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "len": int(cache["len"]) + tokens.shape[1]}
        return logits, new_cache

    # ---------------- public entry points ----------------
    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``forward``'s logits (no aux
        loss), as the JAX model's.  Differentiable on both devices (under
        ``torch.func`` too): every mLSTM layer's ``ops.mlstm`` runs B7 and
        its backward kernels on the card, their plain versions on the
        CPU."""
        logits, _ = self.forward(params, batch["tokens"])
        return layers.softmax_cross_entropy(logits, batch["labels"],
                                            batch.get("loss_mask"))

    def prefill(self, params: Params, batch: dict, max_len: int):
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], max_len,
                                device=tokens.device)
        return self.forward(params, tokens, cache=cache, logits_mode="last")

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor | None = None):
        return self.forward(params, tokens, cache=cache, logits_mode="last")
