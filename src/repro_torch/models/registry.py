"""Model construction and the (arch x shape) cells' input specifications,
the counterpart of ``repro.models.registry``.

``build_model(cfg)`` returns the family's model object (init /
init_cache / prefill / decode_step / loss): ``Seq2SeqLM`` for encdec,
``XLSTMLM`` for ssm, ``CausalLM`` otherwise.

``input_specs(cfg, shape_name)`` returns stand-ins for every input of the
cell's step function: meta-device tensors (no memory) of the JAX specs'
shapes and dtypes, int32 tokens and positions as in JAX.  A decode cell's
cache is the model's own ``init_cache`` on the meta device, whose
``"len"`` is the host int 0 (the JAX spec's is an int32 scalar).
Modality frontends are stubs: vision cells get precomputed patch
embeddings, audio cells precomputed frame embeddings.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import Seq2SeqLM
from repro_torch.models.transformer import CausalLM
from repro_torch.models.xlstm import XLSTMLM

# (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

N_VISION_PATCHES = 256  # stub ViT output length prepended to vision inputs


def build_model(cfg: ModelConfig) -> CausalLM | XLSTMLM | Seq2SeqLM:
    if cfg.family == "encdec":
        return Seq2SeqLM(cfg)
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    return CausalLM(cfg)


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Eligibility for long_500k: SSM / hybrid / sliding-window-dominant."""
    return cfg.family in ("ssm", "hybrid") or cfg.attn_pattern in (
        "sliding", "local_global")


def supports(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return is_subquadratic(cfg)
    return True


def _spec(*shape: int, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _sequence_inputs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    b = {"tokens": _spec(batch, seq)}
    if cfg.mrope_sections:
        b["positions"] = _spec(3, batch, seq)
    if cfg.frontend == "vision":
        b["frontend_embeds"] = _spec(batch, N_VISION_PATCHES, cfg.d_model,
                                     dtype=cfg.compute_dtype)
    if cfg.frontend == "audio":
        b["frontend_embeds"] = _spec(batch, seq, cfg.d_model,
                                     dtype=cfg.compute_dtype)
    return b


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """Stand-ins for the step function of this cell.

    train  -> {"batch": {tokens, labels, ...}}
    prefill-> {"batch": {tokens, ...}}
    decode -> {"cache": <the whole cache>, "tokens", ...}
    """
    seq, batch, kind = SHAPES[shape_name]
    model = build_model(cfg)
    if kind == "train":
        b = _sequence_inputs(cfg, batch, seq)
        return {"batch": {"tokens": b.pop("tokens"), "labels": _spec(
            batch, seq), **b}}
    if kind == "prefill":
        return {"batch": _sequence_inputs(cfg, batch, seq)}
    # decode: one new token against a cache of length `seq`
    if cfg.family == "encdec":
        cache = model.init_cache(batch, seq, seq, device="meta")
    else:
        cache = model.init_cache(batch, seq, device="meta")
    spec = {"cache": cache, "tokens": _spec(batch, 1)}
    if cfg.mrope_sections:
        spec["positions"] = _spec(3, batch, 1)
    return spec


def param_specs(cfg: ModelConfig):
    return build_model(cfg).init(0, device="meta")
