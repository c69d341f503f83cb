"""Intra-service bandwidth allocation (paper §III.A / §IV.A, Eqns. 1-10, 14).

Given a service's bandwidth budget b_n, the optimal per-client split
equalizes completion times (Eq. 6); the optimal round time t*_n is the
unique root of

    h(t) = sum_k alpha_{n,k} / (t - t^C_{n,k}) - b_n = 0        (Eq. 7)

on (max_k t^C_{n,k}, inf).  Every solver here is a fixed-trip bisection
written tensor-wise over a batched ServiceSet, so one call solves every
service at once and no trip waits on the host.  This module is the plain
PyTorch oracle of the ``bisect_alloc`` and ``dual_demand`` kernels.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.types import BISECT_ITERS, ServiceSet

_TINY = 1e-30
_F_CEIL = 1.0 - 1e-6  # stay strictly inside the 1 - tC*f > 0 region

# An f*(b) solver, (ServiceSet, b (N,)) -> f (N,): ``freq`` below, or a
# kernel backend's (``policy.freq_fn``).
FreqFn = Callable[[ServiceSet, torch.Tensor], torch.Tensor]


def _bisect(fn, lo, hi, iters: int = BISECT_ITERS):
    """Batched bisection for a decreasing function (fn(lo) >= 0 >= fn(hi)),
    fixed trip count."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_right = fn(mid) > 0.0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# t*(b) / f*(b): the intra-service optimum.
# ---------------------------------------------------------------------------

def solve_round_time(svc: ServiceSet, b: torch.Tensor,
                     iters: int = BISECT_ITERS) -> torch.Tensor:
    """Optimal round length t*_n(b_n): b (N,) MHz -> (N,) s; +inf for b <= 0.

    Bisection on u = t - max_k t^C over (0, sum_k alpha / b].
    """
    t_cmax = svc.t_comp_max()
    a_sum = svc.alpha_sum()
    safe_b = torch.clamp(b, min=_TINY)
    u_hi = a_sum / safe_b

    # Loop-invariant masking hoisted out of the bisection: alpha is 0 at
    # masked slots and the masked gap is 1, so no trip needs a ``where``.
    alpha_m = torch.where(svc.mask, svc.alpha, 0.0)
    gap = torch.where(svc.mask, t_cmax[:, None] - svc.t_comp, 1.0)

    def h(u):
        return torch.sum(alpha_m / (u[:, None] + gap), dim=-1) - b

    u_star = _bisect(h, torch.zeros_like(u_hi), u_hi, iters)
    t_star = t_cmax + u_star
    return torch.where(b > 0.0, t_star, torch.inf)


def client_allocation(svc: ServiceSet, b: torch.Tensor,
                      iters: int = BISECT_ITERS) -> torch.Tensor:
    """Optimal per-client split b_{n,k} = alpha_{n,k} / (t* - t^C_{n,k}),
    renormalized so each row sums to b exactly.  (N, K)."""
    t_star = solve_round_time(svc, b, iters)
    denom = torch.clamp(t_star[:, None] - svc.t_comp, min=_TINY)
    raw = torch.where(svc.mask, svc.alpha / denom, 0.0)
    total = torch.clamp(torch.sum(raw, dim=-1, keepdim=True), min=_TINY)
    return raw * (b[:, None] / total)


def freq(svc: ServiceSet, b: torch.Tensor,
         iters: int = BISECT_ITERS) -> torch.Tensor:
    """Optimal FL frequency f*_n(b_n) = 1 / t*_n(b_n).  (N,)."""
    t_star = solve_round_time(svc, b, iters)
    return torch.where(torch.isfinite(t_star), 1.0 / t_star, 0.0)


# ---------------------------------------------------------------------------
# Derivatives of f*(b) (Lemma 1) -- closed-form given f.
# ---------------------------------------------------------------------------

def _masked_sum(svc: ServiceSet, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(svc.mask, x, 0.0), dim=-1)


def freq_prime_at_f(svc: ServiceSet, f: torch.Tensor) -> torch.Tensor:
    """f*'(b) at frequency f (Eq. 9): ( sum_k alpha/(1 - tC f)^2 )^-1."""
    one_m = 1.0 - svc.t_comp * f[:, None]
    s = _masked_sum(svc, svc.alpha / torch.clamp(one_m, min=_TINY) ** 2)
    return 1.0 / torch.clamp(s, min=_TINY)


def freq_second_at_f(svc: ServiceSet, f: torch.Tensor) -> torch.Tensor:
    """f*''(b) at frequency f (Eq. 10)."""
    one_m = torch.clamp(1.0 - svc.t_comp * f[:, None], min=_TINY)
    s2 = _masked_sum(svc, svc.alpha / one_m ** 2)
    s3 = _masked_sum(svc, svc.alpha * svc.t_comp / one_m ** 3)
    return -2.0 * s3 / torch.clamp(s2, min=_TINY) ** 3


def bandwidth_from_freq(svc: ServiceSet, f: torch.Tensor) -> torch.Tensor:
    """Invert Eq. 7: b(f) = sum_k alpha_k f / (1 - t^C_k f)."""
    one_m = torch.clamp(1.0 - svc.t_comp * f[:, None], min=_TINY)
    return _masked_sum(svc, svc.alpha * f[:, None] / one_m)


def f_max(svc: ServiceSet) -> torch.Tensor:
    """Supremum frequency 1 / max_k t^C_{n,k} (approached as b -> inf)."""
    return 1.0 / torch.clamp(svc.t_comp_max(), min=_TINY)


def p_max(svc: ServiceSet) -> torch.Tensor:
    """f*'(0) = 1/sum_k alpha (Eq. 32), the price above which demand is 0;
    inactive slots (alpha_sum = 0) get 0."""
    a_sum = svc.alpha_sum()
    return torch.where(a_sum > 0.0, 1.0 / torch.clamp(a_sum, min=_TINY), 0.0)


# ---------------------------------------------------------------------------
# Price -> (frequency, bandwidth): the DISBA inner problem (Eq. 12-14).
# ---------------------------------------------------------------------------

def _price_vector(svc: ServiceSet, lam) -> torch.Tensor:
    lam = torch.as_tensor(lam, dtype=svc.alpha.dtype, device=svc.device)
    return torch.broadcast_to(lam, (svc.n_services,))


def freq_from_price(svc: ServiceSet, lam, iters: int = BISECT_ITERS) -> torch.Tensor:
    """Solve (1 + f) * sum_k alpha_k / (1 - t^C_k f)^2 = 1 / lam for f
    (Eq. 14).  lam may be scalar or (N,); lam >= p_max gives f = 0."""
    lam = _price_vector(svc, lam)
    f_hi = f_max(svc) * _F_CEIL
    target = 1.0 / torch.clamp(lam, min=_TINY)

    # Hoisted loop-invariant masking: alpha_m is 0 at masked slots.
    alpha_m = torch.where(svc.mask, svc.alpha, 0.0)

    def h(f):
        one_m = torch.clamp(1.0 - svc.t_comp * f[:, None], min=_TINY)
        lhs = (1.0 + f) * torch.sum(alpha_m / one_m ** 2, dim=-1)
        return target - lhs

    f_star = _bisect(h, torch.zeros_like(f_hi), f_hi, iters)
    opt_out = lam >= p_max(svc)
    return torch.where(opt_out, 0.0, f_star)


def demand(svc: ServiceSet, lam, iters: int = BISECT_ITERS) -> torch.Tensor:
    """b*_n(lam) = argmax_b [ log(1 + f*(b)) - lam*b ]  (Eq. 12)."""
    return bandwidth_from_freq(svc, freq_from_price(svc, lam, iters))


def price_at_freq(svc: ServiceSet, f: torch.Tensor) -> torch.Tensor:
    """lam(f) = f*'(b)/(1+f*) at frequency f (inverse of Eq. 13)."""
    return freq_prime_at_f(svc, f) / (1.0 + f)
