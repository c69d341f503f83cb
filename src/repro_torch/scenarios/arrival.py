"""Arrival scenario processes: when each FL service enters the network.

Episode-static samplers ``draw(source, n, mean_interval) -> int64 (n,)`` of
non-decreasing arrival periods; every random number comes from ``source``
(``base.Source``), and the arrival times are a pure function of it.

* ``poisson``  -- exponential inter-arrival gaps (the paper's §VI.D process
  and the default);
* ``periodic`` -- an arrival every ``mean_interval`` periods (no draws);
* ``batched``  -- groups of ``group`` services arriving together, with
  exponential gaps between groups;
* ``mmpp``     -- a 2-state Markov-modulated Poisson process: a burst state
  draws gaps ``burst`` times shorter than the mean, a calm state
  compensates so the long-run rate stays ~1/mean_interval; ``stay`` is the
  per-arrival probability of keeping the state.

Arrival periods are the floor of a float32 prefix sum (``types.cumsum``,
the reference's add order).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import cumsum
from repro_torch.scenarios.base import register


def _periods(gaps: torch.Tensor) -> torch.Tensor:
    return torch.floor(cumsum(gaps)).to(torch.int64)


@register("arrival", "poisson")
def poisson():
    def draw(source, n, mean_interval):
        return _periods(source.exponential("gaps", (n,)) * mean_interval)

    return draw


@register("arrival", "periodic")
def periodic():
    def draw(source, n, mean_interval):
        del source  # deterministic
        return torch.floor(torch.arange(n, dtype=torch.float32)
                           * mean_interval).to(torch.int64)

    return draw


@register("arrival", "batched")
def batched(group: int = 3):
    group = int(group)
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")

    def draw(source, n, mean_interval):
        n_groups = -(-n // group)
        gaps = source.exponential("gaps", (n_groups,)) * (mean_interval * group)
        return torch.repeat_interleave(_periods(gaps), group)[:n]

    return draw


def mmpp_gaps(state0: torch.Tensor, flips: torch.Tensor, gaps: torch.Tensor,
              means: torch.Tensor) -> torch.Tensor:
    """The MMPP chain as a pure function of its draws: arrival i runs in
    state s_i (s_0 = ``state0``, s_{i+1} = 1 - s_i where ``flips[i]``) and
    its gap is ``gaps[i] * means[s_i]``."""
    flipped_before = cumsum(flips.to(torch.int64)) - flips.to(torch.int64)
    state = (state0.to(torch.int64) + flipped_before) % 2
    return gaps * means[state]


@register("arrival", "mmpp")
def mmpp(burst: float = 6.0, stay: float = 0.7):
    burst = float(burst)
    stay = float(stay)
    if burst < 1.0:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if not 0.0 <= stay < 1.0:
        raise ValueError(f"stay must be in [0, 1), got {stay}")

    def draw(source, n, mean_interval):
        # Equal-occupancy two-state chain; state means average to the mean.
        means = torch.tensor(
            [mean_interval / burst, mean_interval * (2.0 - 1.0 / burst)],
            dtype=torch.float32)
        state0 = source.uniform("state0", ()) < 0.5        # bernoulli(0.5)
        flips = source.uniform("flips", (n,)) >= stay
        gaps = source.exponential("gaps", (n,))
        return _periods(mmpp_gaps(state0, flips, gaps,
                                  means.to(gaps.device)))

    return draw
