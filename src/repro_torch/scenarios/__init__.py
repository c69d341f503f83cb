"""Stochastic scenario processes for the multi-period simulator.

The registry mirrors ``repro.scenarios``: channel ``iid``,
``gauss_markov``, ``rayleigh_block``; arrival ``poisson``, ``periodic``,
``batched``, ``mmpp``; churn ``none``, ``bernoulli``, ``gilbert``.  Every
process draws through a ``Source`` (``base``), so a caller can inject the
draws.
"""
from __future__ import annotations

from repro_torch.scenarios import arrival, channel, churn  # noqa: F401  (register)
from repro_torch.scenarios.base import (CHURN_SALT, COTRAIN_SALT,
                                        FADING_SALT, INIT_SALT, KINDS,
                                        STREAMS, ArraySource,
                                        GeneratorSource, Process, ScenarioSpec,
                                        Source, as_spec, available,
                                        generator, get_process, register,
                                        spec)

__all__ = [
    "CHURN_SALT", "COTRAIN_SALT", "FADING_SALT", "INIT_SALT", "KINDS",
    "STREAMS",
    "ArraySource", "GeneratorSource", "Process", "ScenarioSpec", "Source",
    "as_spec", "available", "generator", "get_process", "register", "spec",
    "get_channel", "get_arrival", "get_churn",
]


def get_channel(sp, net) -> Process:
    """Build a channel Process from a registry key / ScenarioSpec."""
    return get_process("channel", as_spec(sp, default="iid"), net=net)


def get_churn(sp, net) -> Process:
    """Build a churn Process from a registry key / ScenarioSpec."""
    return get_process("churn", as_spec(sp, default="none"), net=net)


def get_arrival(sp):
    """Build an arrival sampler ``draw(source, n, mean_interval)``."""
    return get_process("arrival", as_spec(sp, default="poisson"))
