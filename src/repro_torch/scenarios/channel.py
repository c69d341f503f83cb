"""Channel scenario processes: how per-period wireless state evolves.

Ported so far: ``iid``, the identity process (the paper's i.i.d. redraw
each period).  The correlated processes are a later slice.
"""
from __future__ import annotations

from repro_torch.scenarios.base import Process, register


@register("channel", "iid")
def iid():
    """Identity: keep the period's i.i.d. base sample (paper default)."""

    def init(generator, n, k):
        return ()

    def step(generator, state, svc):
        return state, svc

    return Process(init, step)
