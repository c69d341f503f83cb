"""Client-churn scenario processes: per-period availability of FL clients.

Pure mask perturbations on the fixed-capacity ``ServiceSet``
(``types.mask_clients``).  A service whose clients all drop for a period
makes no FL progress that period (b = f = 0) while its duration counts on.

* ``none``      -- identity (every enrolled client in every round, the
  paper's assumption);
* ``bernoulli`` -- each client unavailable with probability ``p_drop``
  each period, independently;
* ``gilbert``   -- a two-state availability chain per client: an available
  client drops with ``p_drop``, a dropped one returns with ``p_return``;
  it starts at the steady state p_return / (p_drop + p_return).

Both stochastic processes take ``always_keep``: the first that many client
slots of every service never drop.  Their uniforms come from the source's
``"churn"`` stream (``"init_churn"`` for gilbert's start).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import mask_clients
from repro_torch.scenarios.base import Process, register


def _validate_prob(p: float, name: str) -> float:
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {p}")
    return p


def _keep_mask(k: int, always_keep: int, device) -> torch.Tensor:
    return torch.arange(k, device=device) < always_keep


def bernoulli_avail(u: torch.Tensor, p_drop: float,
                    always_keep: int) -> torch.Tensor:
    """Memoryless availability from the period's uniforms (N, K)."""
    return (u >= p_drop) | _keep_mask(u.shape[-1], always_keep, u.device)


def gilbert_avail(state: torch.Tensor, u: torch.Tensor, p_drop: float,
                  p_return: float, always_keep: int) -> torch.Tensor:
    """One step of the Gilbert chain from the period's uniforms (N, K)."""
    avail = torch.where(state, u >= p_drop, u < p_return)
    return avail | _keep_mask(u.shape[-1], always_keep, u.device)


@register("churn", "none")
def none():
    def init(source, n, k):
        return ()

    def step(source, state, svc):
        return state, svc

    return Process(init, step)


@register("churn", "bernoulli")
def bernoulli(p_drop: float = 0.2, always_keep: int = 0):
    p = _validate_prob(p_drop, "p_drop")
    always_keep = int(always_keep)

    def init(source, n, k):
        return ()

    def step(source, state, svc):
        u = source.uniform("churn", tuple(svc.mask.shape))
        return state, mask_clients(svc, bernoulli_avail(u, p, always_keep))

    return Process(init, step)


@register("churn", "gilbert")
def gilbert(p_drop: float = 0.1, p_return: float = 0.4, always_keep: int = 0):
    p_d = _validate_prob(p_drop, "p_drop")
    p_r = _validate_prob(p_return, "p_return")
    always_keep = int(always_keep)
    # The frozen chain (both probabilities 0) never moves: all available.
    steady = p_r / (p_d + p_r) if (p_d + p_r) > 0.0 else 1.0

    def init(source, n, k):
        u = source.uniform("init_churn", (n, k))
        return (u < steady) | _keep_mask(k, always_keep, u.device)

    def step(source, state, svc):
        u = source.uniform("churn", tuple(svc.mask.shape))
        avail = gilbert_avail(state, u, p_d, p_r, always_keep)
        return avail, mask_clients(svc, avail)

    return Process(init, step)
