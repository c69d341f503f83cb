"""Model construction, the counterpart of ``repro.models.registry``.

``build_model(cfg)`` returns the family's model object (init / init_cache /
forward / prefill / decode_step): ``XLSTMLM`` for the ssm family, the
dense ``CausalLM`` otherwise, which raises for what is not yet ported.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import CausalLM
from repro_torch.models.xlstm import XLSTMLM


def build_model(cfg: ModelConfig) -> CausalLM | XLSTMLM:
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    return CausalLM(cfg)
