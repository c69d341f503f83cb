"""Benchmark allocation policies from §VI.D.

  * Equal-Client (EC):  every client network-wide gets B / sum_n K_n; no
    intra-service optimization (round gated by the worst client).
  * Equal-Service (ES): every service gets B / N, then splits it optimally.
  * Proportional (PP):  service n gets B * K_n / sum_j K_j, split optimally.

ES and PP take the f*(b) solver as ``freq`` (``policy.freq_fn`` of an intra
backend), so f is computed once, by that backend; the default is the plain
``intra.freq``.
"""
from __future__ import annotations

import torch

from repro_torch.core import intra
from repro_torch.core.types import ServiceSet, round_time_given_alloc


def equal_client(svc: ServiceSet, total_bandwidth: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (b_service, f) under uniform per-client bandwidth."""
    counts = svc.client_counts().to(svc.alpha.dtype)
    per_client = total_bandwidth / torch.clamp(torch.sum(counts), min=1.0)
    b_clients = torch.where(svc.mask, per_client, 0.0)
    t = round_time_given_alloc(svc, b_clients)
    return counts * per_client, 1.0 / t


def equal_service(svc: ServiceSet, total_bandwidth: float,
                  freq: intra.FreqFn | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    active = svc.service_active()
    n_active = torch.clamp(torch.sum(active.to(svc.alpha.dtype)), min=1.0)
    b = torch.where(active, total_bandwidth / n_active, 0.0).to(svc.alpha.dtype)
    return b, (intra.freq if freq is None else freq)(svc, b)


def proportional(svc: ServiceSet, total_bandwidth: float,
                 freq: intra.FreqFn | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    counts = svc.client_counts().to(svc.alpha.dtype)
    b = total_bandwidth * counts / torch.clamp(torch.sum(counts), min=1.0)
    return b, (intra.freq if freq is None else freq)(svc, b)
