"""Fairness-adjusted utilities and exact market clearing (paper §V.B).

The fairness-adjusted benefit of provider n is

    g_n(b) = (1 - alpha_fair) * f*_n(b) + alpha_fair * log(1 + f*_n(b))

(Eq. 21).  Its derivative is the modified marginal valuation function
q_n(b) = g'_n(b), and its inverse the modified bandwidth demand function
(mBDF) d_n(p) = (g'_n)^{-1}(p).  The modified market clearing price solves
sum_n d_n(zeta) = B (Prop. 3).  alpha_fair = 0 maximizes total frequency;
alpha_fair = 1 is proportional fairness, the cooperative DISBA optimum.

``mbdf_grid(backend="pallas")`` evaluates a whole (N, M) price grid with
the ``mbdf_demand`` kernel (``kernels.ops``); ``"reference"`` is the joint
bisection over N*M replicated rows below.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import intra
from repro_torch.core.types import BISECT_ITERS, ServiceSet
from repro_torch.kernels import ops

_TINY = 1e-30

MBDF_BACKENDS = ("reference", "pallas")


def g_value(f: torch.Tensor, alpha_fair: float) -> torch.Tensor:
    """g_n expressed at frequency f (Eq. 21's benefit part)."""
    return (1.0 - alpha_fair) * f + alpha_fair * torch.log1p(f)


def g_prime_at_f(svc: ServiceSet, f: torch.Tensor,
                 alpha_fair: float) -> torch.Tensor:
    """q_n(b) = g'_n(b) at frequency f: [(1-a) + a/(1+f)] * f*'(b).
    (A true division: a Python scalar over a tensor is a reciprocal and a
    product in PyTorch.)"""
    w = (1.0 - alpha_fair) + torch.full_like(f, alpha_fair) / (1.0 + f)
    return w * intra.freq_prime_at_f(svc, f)


def fairness_cost(f: torch.Tensor, alpha_fair: float) -> torch.Tensor:
    """The ex-post fairness-adjusted charge alpha * (f - log(1+f)) (§V.B.2)."""
    return alpha_fair * (f - torch.log1p(f))


def mbdf(svc: ServiceSet, price, alpha_fair: float,
         iters: int = BISECT_ITERS) -> torch.Tensor:
    """Modified bandwidth demand d_n(p) = (g'_n)^{-1}(p) per service -> (N,).

    q is decreasing in b, so bisect f on [0, f_max (1 - 1e-6)) for
    q(f) = p and map f to b by Eq. 7.  Demand is 0 for p >= q(0) =
    1/sum(alpha).  ``price``: scalar or (N,).
    """
    price = torch.broadcast_to(
        torch.as_tensor(price, dtype=svc.alpha.dtype, device=svc.device),
        (svc.n_services,))
    f_hi = intra.f_max(svc) * (1.0 - 1e-6)

    def h(f):  # decreasing in f: the sign convention of intra._bisect
        return g_prime_at_f(svc, f, alpha_fair) - price

    f_star = intra._bisect(h, torch.zeros_like(f_hi), f_hi, iters)
    f_star = torch.where(price >= intra.p_max(svc), 0.0, f_star)
    return intra.bandwidth_from_freq(svc, f_star)


def mbdf_grid(svc: ServiceSet, prices: torch.Tensor, alpha_fair: float,
              iters: int = BISECT_ITERS,
              backend: str = "reference") -> torch.Tensor:
    """Modified bandwidth demand at a whole (N, M) price grid -> (N, M).

    ``"reference"``: one joint bisection over the grid flattened to an
    (N*M)-row replicated ServiceSet, through ``mbdf`` itself.
    ``"pallas"``: the ``mbdf_demand`` kernel (its plain version on CPU
    tensors), which reads each service row once for all M prices.
    """
    prices = torch.as_tensor(prices, dtype=svc.alpha.dtype, device=svc.device)
    if backend == "pallas":
        return ops.mbdf_demand(svc.alpha.contiguous(),
                               svc.t_comp.contiguous(), prices.contiguous(),
                               alpha_fair, iters=iters)
    if backend != "reference":
        raise ValueError(f"unknown mbdf backend {backend!r}; "
                         f"expected one of {MBDF_BACKENDS}")
    n, m = prices.shape
    rep = ServiceSet(
        alpha=torch.repeat_interleave(svc.alpha, m, dim=0),
        t_comp=torch.repeat_interleave(svc.t_comp, m, dim=0),
        mask=torch.repeat_interleave(svc.mask, m, dim=0),
    )
    return mbdf(rep, prices.reshape(-1), alpha_fair, iters).reshape(n, m)


class ClearingResult(NamedTuple):
    b: torch.Tensor      # (N,) allocation
    f: torch.Tensor      # (N,) resulting frequencies
    price: torch.Tensor  # () clearing price


def exact_mmcp(svc: ServiceSet, total_bandwidth: float, alpha_fair: float,
               iters: int = BISECT_ITERS,
               inner_iters: int = BISECT_ITERS) -> ClearingResult:
    """Full-information modified market clearing (Prop. 3): bisect the price
    until aggregate modified demand equals B.  The reference the multi-bid
    auction approximates with M bids."""
    b_total = torch.tensor(total_bandwidth, dtype=torch.float32,
                           device=svc.device)
    p_hi = torch.amax(intra.p_max(svc))

    def h(p):
        return torch.sum(mbdf(svc, p, alpha_fair, inner_iters)) - b_total

    price = intra._bisect(h, torch.zeros_like(p_hi), p_hi, iters)
    b = mbdf(svc, price, alpha_fair, inner_iters)
    b = b * (b_total / torch.clamp(torch.sum(b), min=_TINY))
    return ClearingResult(b=b, f=intra.freq(svc, b, inner_iters), price=price)


def provider_utility(svc: ServiceSet, b: torch.Tensor, price,
                     alpha_fair: float) -> torch.Tensor:
    """u_n = f*(b) - p*b - alpha*(f*(b) - log(1+f*(b)))  (Eq. 21 with both
    charges)."""
    f = intra.freq(svc, b)
    return f - price * b - fairness_cost(f, alpha_fair)
