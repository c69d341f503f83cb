"""Client-churn scenario processes: per-period availability of FL clients.

Ported so far: ``none``, the identity (every enrolled client participates
in every round, as the paper assumes).
"""
from __future__ import annotations

from repro_torch.scenarios.base import Process, register


@register("churn", "none")
def none():
    def init(generator, n, k):
        return ()

    def step(generator, state, svc):
        return state, svc

    return Process(init, step)
