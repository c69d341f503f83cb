"""Core data structures for the multi-service FL bandwidth-allocation problem.

Canonical units (the paper's §VI.A setup, all quantities O(1) in float32):
bandwidth in MHz, data sizes in Mbit, base rates in bit/s/Hz, times in
seconds, frequencies in rounds / second.

For allocation purposes a service n reduces to two per-client scalars
(Eqns. 3-7):

    alpha_{n,k} = s_DT/r_DT_k + s_UT/r_UT_k       [MHz * s]  (transmission load)
    t_comp_{n,k} = w_LC_k/phi_k + w_GC/phi_n      [s]        (compute latency)

Services are batched into rectangular (N, K_max) tensors with a validity
mask.  Masked slots carry alpha = 0 and t_comp = 0 (``mask_inactive`` /
``mask_clients``), the convention every solver and kernel relies on.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Fixed-trip bisection count.  48 halvings shrink any O(1) bracket to ~4e-15
# of its width -- far below float32 resolution.
BISECT_ITERS = 48

_NEG_INF = -1e30


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the card."""
    return torch.device("cuda")


class ServiceSet(NamedTuple):
    """A padded batch of FL services, all tensors on one device.

    alpha:    (N, K) float32 -- per-client transmission load, 0 at masked slots.
    t_comp:   (N, K) float32 -- per-client compute latency, 0 at masked slots.
    mask:     (N, K) bool    -- True for real clients.
    alpha_ul: (N, K) float32 or None -- the dense uplink component
              s^UT/r^UT_k of alpha, read only by ``scale_uplink``.
    """

    alpha: torch.Tensor
    t_comp: torch.Tensor
    mask: torch.Tensor
    alpha_ul: torch.Tensor | None = None

    @property
    def n_services(self) -> int:
        return self.alpha.shape[0]

    @property
    def k_max(self) -> int:
        return self.alpha.shape[1]

    @property
    def device(self) -> torch.device:
        return self.alpha.device

    def alpha_sum(self) -> torch.Tensor:
        """Sum_k alpha_{n,k} -> (N,).  Padding contributes 0 by construction."""
        return torch.sum(self.alpha, dim=-1)

    def t_comp_max(self) -> torch.Tensor:
        """max_k t^C_{n,k} over valid clients -> (N,)."""
        return torch.amax(torch.where(self.mask, self.t_comp, _NEG_INF), dim=-1)

    def client_counts(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    def service_active(self) -> torch.Tensor:
        """(N,) bool -- True for services with at least one real client."""
        return torch.any(self.mask, dim=-1)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_service_set(alpha, t_comp, mask=None, alpha_ul=None, *,
                     device=None) -> ServiceSet:
    """Build a ServiceSet from array-likes; 1-D inputs become one service.

    ``device`` defaults to the device of ``alpha`` when it is a tensor, else
    to the card.
    """
    if device is None:
        device = (alpha.device if isinstance(alpha, torch.Tensor)
                  else default_device())
    alpha = _f32(alpha, device)
    t_comp = _f32(t_comp, device)
    if alpha.ndim == 1:
        alpha, t_comp = alpha[None], t_comp[None]
    if mask is None:
        mask = torch.ones(alpha.shape, dtype=torch.bool, device=device)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
        if mask.ndim == 1:
            mask = mask[None]
    alpha = torch.where(mask, alpha, 0.0)
    if alpha_ul is not None:
        alpha_ul = _f32(alpha_ul, device)
        if alpha_ul.ndim == 1:
            alpha_ul = alpha_ul[None]
        alpha_ul = torch.where(mask, alpha_ul, 0.0)
    return ServiceSet(alpha=alpha, t_comp=t_comp, mask=mask, alpha_ul=alpha_ul)


@dataclasses.dataclass(frozen=True)
class RawServiceParams:
    """Physical-layer description of one service before reduction to
    (alpha, t_comp).  All tensors are (K,) over this service's clients."""

    s_dl_mbit: float          # download payload s^DT_n  [Mbit]
    s_ul_mbit: float          # upload payload  s^UT_n  [Mbit]
    r_dl: torch.Tensor        # downlink base rate log2(1 + P_n g^dl_k / N0)
    r_ul: torch.Tensor        # uplink base rate  log2(1 + P_k g^ul_k / N0)
    t_local: torch.Tensor     # local-computation latency w^LC_{n,k} / phi_k [s]
    t_global: float           # aggregation latency w^GC_n / phi_n  [s]

    def reduce(self) -> tuple[torch.Tensor, torch.Tensor]:
        alpha = self.s_dl_mbit / self.r_dl + self.s_ul_mbit / self.r_ul
        t_comp = self.t_local + self.t_global
        return alpha, t_comp

    def reduce_parts(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Like ``reduce`` but also returns the uplink component s^UT/r^UT."""
        alpha_ul = self.s_ul_mbit / self.r_ul
        alpha = self.s_dl_mbit / self.r_dl + self.s_ul_mbit / self.r_ul
        t_comp = self.t_local + self.t_global
        return alpha, t_comp, alpha_ul


def stack_services(params: list[RawServiceParams],
                   k_max: int | None = None) -> ServiceSet:
    """Pad a heterogeneous list of services into one rectangular ServiceSet
    on the device of the first service's rates."""
    reduced = [p.reduce_parts() for p in params]
    counts = [int(a.shape[0]) for a, _, _ in reduced]
    k_pad = k_max if k_max is not None else max(counts)
    n = len(params)
    device = reduced[0][0].device
    alpha = torch.zeros((n, k_pad), dtype=torch.float32, device=device)
    t_comp = torch.zeros_like(alpha)
    alpha_ul = torch.zeros_like(alpha)
    mask = torch.zeros((n, k_pad), dtype=torch.bool, device=device)
    for i, (a, tc, aul) in enumerate(reduced):
        k = counts[i]
        alpha[i, :k] = a.to(torch.float32)
        t_comp[i, :k] = tc.to(torch.float32)
        alpha_ul[i, :k] = aul.to(torch.float32)
        mask[i, :k] = True
    return ServiceSet(alpha=alpha, t_comp=t_comp, mask=mask, alpha_ul=alpha_ul)


def _keep(svc: ServiceSet, keep: torch.Tensor) -> ServiceSet:
    return ServiceSet(
        alpha=torch.where(keep, svc.alpha, 0.0),
        t_comp=torch.where(keep, svc.t_comp, 0.0),
        mask=keep,
        alpha_ul=(None if svc.alpha_ul is None
                  else torch.where(keep, svc.alpha_ul, 0.0)),
    )


def mask_inactive(svc: ServiceSet, active: torch.Tensor) -> ServiceSet:
    """Deactivate whole services by flipping masks: inactive rows keep their
    shape but drop every client (alpha -> 0, t_comp -> 0, mask -> False)."""
    row = torch.as_tensor(active, dtype=torch.bool, device=svc.device)[:, None]
    return _keep(svc, torch.logical_and(svc.mask, row))


def mask_clients(svc: ServiceSet, available: torch.Tensor) -> ServiceSet:
    """Drop individual clients by flipping mask bits, exactly like padding.
    ``available``: (N, K) bool."""
    avail = torch.as_tensor(available, dtype=torch.bool, device=svc.device)
    return _keep(svc, torch.logical_and(svc.mask, avail))


def scale_uplink(svc: ServiceSet, ul_mult: torch.Tensor) -> ServiceSet:
    """alpha' = alpha - (1 - ul_mult_n) * alpha_ul, with ``ul_mult`` (N,)
    clipped to [0, 1]; ``alpha_ul`` stays the dense uplink load."""
    if svc.alpha_ul is None:
        raise ValueError(
            "scale_uplink needs ServiceSet.alpha_ul (the dynamic s^UT "
            "column); build the set via sample_services/stack_services or "
            "pass alpha_ul to make_service_set")
    m = torch.clamp(torch.as_tensor(ul_mult, dtype=svc.alpha.dtype,
                                    device=svc.device), 0.0, 1.0)
    alpha = svc.alpha - (1.0 - m[:, None]) * svc.alpha_ul
    return svc._replace(alpha=alpha)


def round_time_given_alloc(svc: ServiceSet,
                           b_clients: torch.Tensor) -> torch.Tensor:
    """Round length t_n = max_k (t^C_{n,k} + alpha_{n,k}/b_{n,k}) for an
    arbitrary per-client allocation b_clients (N, K) MHz."""
    safe_b = torch.clamp(b_clients, min=1e-30)
    per_client = svc.t_comp + svc.alpha / safe_b
    return torch.amax(torch.where(svc.mask, per_client, _NEG_INF), dim=-1)
