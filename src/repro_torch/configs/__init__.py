"""Architecture registry: the JAX package's ten names, with the exact public
config of each and its reduced smoke variant for CPU tests."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "gemma-2b": "gemma_2b",
    "gemma-7b": "gemma_7b",
    "command-r-35b": "command_r_35b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)
