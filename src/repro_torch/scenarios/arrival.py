"""Arrival scenario processes: when each FL service enters the network.

Episode-static samplers ``draw(generator, n, mean_interval) -> int64 (n,)``
of non-decreasing arrival periods.  Ported so far: ``poisson``, exponential
inter-arrival gaps (the paper's §VI.D process and the default).
"""
from __future__ import annotations

import torch

from repro_torch.scenarios.base import register


@register("arrival", "poisson")
def poisson():
    def draw(generator, n, mean_interval):
        gaps = torch.empty((n,), dtype=torch.float32, device=generator.device)
        gaps = gaps.exponential_(generator=generator) * mean_interval
        return torch.floor(torch.cumsum(gaps, dim=0)).to(torch.int64)

    return draw
