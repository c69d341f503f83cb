"""Model construction, the counterpart of ``repro.models.registry``.

``build_model(cfg)`` returns the family's model object (init / init_cache /
forward / prefill / decode_step).  Only the dense family is ported so far.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import CausalLM


def build_model(cfg: ModelConfig) -> CausalLM:
    """The dense ``CausalLM``; it raises for what is not yet ported,
    other families included."""
    return CausalLM(cfg)
