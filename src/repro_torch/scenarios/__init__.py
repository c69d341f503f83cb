"""Stochastic scenario processes for the multi-period simulator.

The registry mirrors ``repro.scenarios``; so far only the paper's defaults
are ported (channel ``iid``, arrival ``poisson``, churn ``none``), and any
other name raises a ValueError.
"""
from __future__ import annotations

from repro_torch.scenarios import arrival, channel, churn  # noqa: F401  (register)
from repro_torch.scenarios.base import (KINDS, Process, ScenarioSpec, as_spec,
                                        available, get_process, register, spec)

__all__ = [
    "KINDS", "Process", "ScenarioSpec", "as_spec", "available",
    "get_process", "register", "spec",
    "get_channel", "get_arrival", "get_churn",
]


def get_channel(sp, net) -> Process:
    """Build a channel Process from a registry key / ScenarioSpec."""
    return get_process("channel", as_spec(sp, default="iid"), net=net)


def get_churn(sp, net) -> Process:
    """Build a churn Process from a registry key / ScenarioSpec."""
    return get_process("churn", as_spec(sp, default="none"), net=net)


def get_arrival(sp):
    """Build an arrival sampler ``draw(generator, n, mean_interval)``."""
    return get_process("arrival", as_spec(sp, default="poisson"))
