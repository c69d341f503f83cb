"""Architecture registry: the JAX package's ten names, with the exact public
config of each ported one and its reduced smoke variant for CPU tests.
gemma3-1b and xlstm-1.3b are ported; the other names raise."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "gemma-2b": None,
    "gemma-7b": None,
    "command-r-35b": None,
    "qwen2-vl-7b": None,
    "seamless-m4t-large-v2": None,
    "llama4-maverick-400b-a17b": None,
    "deepseek-v2-236b": None,
    "hymba-1.5b": None,
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    if _MODULES[name] is None:
        raise NotImplementedError(f"arch {name!r} is not yet ported")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)
