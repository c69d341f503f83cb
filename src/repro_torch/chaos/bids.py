"""Strategic-bidder chaos: seeded unilateral deviations against the
fairness-adjusted multi-bid auction (``core.auction``).

The paper's Prop. 5 claims truthful bidding is an ex-post Delta-Nash
equilibrium: no provider can gain more than ``auction.delta_bound`` (Eq.
31) by deviating from its truthful book.  ``BidChaos`` attacks that claim
empirically: seeded draws on the ``(salt, seed, period, crc32(channel))``
scheme pick a provider, a deviation and a magnitude, replace that
provider's row of the truthful ``MultiBid``, re-clear the market, and
report the *empirical regret* (utility gained over bidding truthfully)
against the theoretical bound.

Deviation catalogue:

* ``overbid``   demands scaled by ``factor > 1``: claim more bandwidth at
                every announced price.
* ``shade``     demands scaled by ``factor < 1``: understate demand to
                duck the exclusion-compensation charge.
* ``free_ride`` demand only at the lowest announced price.

Charges for deviated books use ``method="rerun"``: the closed-form prefix
charges are exact only for truthful-shaped books.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.chaos.schedule import ChaosSchedule
from repro_torch.core import auction, intra
from repro_torch.core.types import ServiceSet

DEVIATIONS = ("overbid", "shade", "free_ride")


def deviate_bid(bid: auction.MultiBid, n: int, kind: str,
                factor: float) -> auction.MultiBid:
    """Provider ``n``'s unilateral deviation from the (truthful) book.
    Prices are operator-announced and stay fixed; only n's demand row
    moves.  Every deviation keeps the demands non-increasing in m."""
    demands = bid.demands.detach().cpu().numpy().copy()
    if kind in ("overbid", "shade"):
        demands[n] = demands[n] * factor
    elif kind == "free_ride":
        row = np.zeros_like(demands[n])
        row[0] = demands[n][0]
        demands[n] = row
    else:
        raise ValueError(
            f"unknown bid deviation {kind!r}; known: {DEVIATIONS}")
    return auction.MultiBid(prices=bid.prices, demands=torch.as_tensor(
        demands, device=bid.demands.device))


def _utility(svc: ServiceSet, bid: auction.MultiBid, total_bandwidth: float,
             alpha_fair: float, p_reserve: float = 0.0) -> np.ndarray:
    """(N,) realized utilities f - c under this book (Eq. 28), with the
    leave-one-out rerun charges (exact for arbitrary books)."""
    b, _ = auction.allocate(bid, total_bandwidth, p_reserve)
    c = auction.charges(svc, bid, b, total_bandwidth, alpha_fair, p_reserve,
                        method="rerun")
    f = intra.freq(svc, b)
    return (f - c).detach().cpu().numpy().astype(np.float64)


def audit_deviation(svc: ServiceSet, total_bandwidth: float, n: int,
                    kind: str, factor: float, *, n_bids: int = 5,
                    alpha_fair: float = 0.5,
                    p_reserve: float = 0.0) -> dict:
    """One unilateral deviation, measured: provider ``n``'s utility under
    the truthful book vs after the deviation, the empirical gain, and the
    Eq. 31 truthfulness gap it must stay under."""
    truthful = auction.uniform_truthful_bids(svc, n_bids, alpha_fair,
                                             p_reserve)
    u_truth = _utility(svc, truthful, total_bandwidth, alpha_fair, p_reserve)
    dev = deviate_bid(truthful, n, kind, factor)
    u_dev = _utility(svc, dev, total_bandwidth, alpha_fair, p_reserve)
    delta = float(auction.delta_bound(svc, truthful, alpha_fair,
                                      p_reserve)[n])
    gain = float(u_dev[n] - u_truth[n])
    return {
        "provider": int(n), "deviation": kind, "factor": float(factor),
        "u_truthful": float(u_truth[n]), "u_deviated": float(u_dev[n]),
        "gain": gain, "regret": max(0.0, gain), "delta_bound": delta,
    }


class BidChaos:
    """Seeded sweep of unilateral deviations: every trial's (provider,
    deviation, magnitude) draw comes off the dedicated ``bid`` channel of a
    ``ChaosSchedule``, so a manipulation campaign replays from its seed."""

    name = "bids"

    def __init__(self, seed: int, deviations: tuple[str, ...] = DEVIATIONS):
        self.schedule = ChaosSchedule(seed)
        self.deviations = tuple(deviations)

    def draw(self, trial: int, n_providers: int) -> tuple[int, str, float]:
        rng = self.schedule.rng(trial, "bid")
        n = int(rng.integers(n_providers))
        kind = self.deviations[int(rng.integers(len(self.deviations)))]
        if kind == "overbid":
            factor = float(1.0 + 3.0 * rng.random())      # 1x .. 4x
        elif kind == "shade":
            factor = float(0.2 + 0.7 * rng.random())      # 0.2 .. 0.9
        else:
            factor = 0.0                                   # free_ride: unused
        return n, kind, factor

    def run(self, svc: ServiceSet, total_bandwidth: float, n_trials: int, *,
            n_bids: int = 5, alpha_fair: float = 0.5,
            p_reserve: float = 0.0) -> list[dict]:
        n_providers = int(svc.alpha.shape[0])
        rows = []
        for t in range(n_trials):
            n, kind, factor = self.draw(t, n_providers)
            row = audit_deviation(
                svc, total_bandwidth, n, kind, factor, n_bids=n_bids,
                alpha_fair=alpha_fair, p_reserve=p_reserve)
            row["trial"] = t
            rows.append(row)
        return rows
