"""Wireless-network and workload samplers reproducing the paper's §VI.A setup.

Defaults (paper values):
  * total bandwidth B = 10 MHz, period T = 20 s
  * noise power N0 = 1e-12 W
  * client count K_n ~ Normal(25, var 15), clipped to >= 2
  * path loss [dB]  ~ Normal(85, var 15)  (per-service mean, then per-client)
  * model size      ~ U[0.2, 0.5] Mbit (download = upload payload)
  * local training time ~ U[0.01, 0.05] s ; global aggregation 1e-5 s
  * uplink power   ~ U[0.05, 0.15] W ; downlink power ~ U[0.1, 0.3] W

Randomness comes from an explicit ``torch.Generator``.  The draws
(``sample_draws`` -> ``ServiceDraws``) are split from the arithmetic that
turns them into a ServiceSet (``services_from_draws``), so a caller holding
another generator's draws (a differential test) can feed them through the
same arithmetic, and a channel process can swap the path-loss normals.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.types import ServiceSet

B_TOTAL_MHZ = 10.0
PERIOD_S = 20.0
NOISE_W = 1e-12


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    total_bandwidth_mhz: float = B_TOTAL_MHZ
    period_s: float = PERIOD_S
    noise_w: float = NOISE_W
    mean_clients: float = 25.0
    var_clients: float = 15.0
    mean_pathloss_db: float = 85.0
    var_pathloss_db: float = 15.0       # across-service variance
    var_pathloss_client_db: float = 4.0  # within-service client spread
    model_mbit_lo: float = 0.2
    model_mbit_hi: float = 0.5
    t_local_lo: float = 0.01
    t_local_hi: float = 0.05
    t_global: float = 1e-5
    p_ul_lo: float = 0.05
    p_ul_hi: float = 0.15
    p_dl_lo: float = 0.1
    p_dl_hi: float = 0.3
    k_min: int = 2


def base_rate(power_w: torch.Tensor, pathloss_db: torch.Tensor,
              noise_w: float = NOISE_W) -> torch.Tensor:
    """Shannon spectral efficiency log2(1 + P*g/N0), g = 10^(-PL/10)."""
    gain = torch.pow(10.0, -pathloss_db / 10.0)
    return torch.log2(1.0 + power_w * gain / noise_w)


def sample_client_counts(generator: torch.Generator, n: int,
                         cfg: NetworkConfig) -> torch.Tensor:
    eps = torch.randn((n,), generator=generator, device=generator.device)
    k = cfg.mean_clients + math.sqrt(cfg.var_clients) * eps
    return torch.clamp(torch.round(k), min=cfg.k_min).to(torch.int32)


def _uniform(generator, shape, lo, hi):
    """lo + u (hi - lo), u ~ U[0, 1), in place: the same float32 operations
    without two more (N, K) buffers a period."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.mul_(hi - lo).add_(lo)


def services_from_draws(client_counts: torch.Tensor, k_max: int,
                        eps_service: torch.Tensor, eps_client: torch.Tensor,
                        size_mbit: torch.Tensor, p_ul: torch.Tensor,
                        p_dl: torch.Tensor, t_local: torch.Tensor,
                        cfg: NetworkConfig = NetworkConfig(),
                        extra_pathloss_db: torch.Tensor | None = None,
                        ) -> tuple[ServiceSet, dict]:
    """The arithmetic of ``sample_services`` after the draws.

    Shapes: ``eps_service`` (N, 1) and ``eps_client`` (N, K) standard normal
    path-loss innovations; ``size_mbit`` (N, 1), ``p_ul`` (N, K), ``p_dl``
    (N, 1), ``t_local`` (N, K) already scaled to their ranges.
    """
    device = eps_client.device
    client_counts = client_counts.to(device=device, dtype=torch.int32)
    mask = (torch.arange(k_max, device=device)[None, :]
            < client_counts[:, None])
    pl_service = cfg.mean_pathloss_db + math.sqrt(cfg.var_pathloss_db) * eps_service
    pl_clients = pl_service + math.sqrt(cfg.var_pathloss_client_db) * eps_client
    if extra_pathloss_db is not None:
        pl_clients = pl_clients + extra_pathloss_db

    r_dl = base_rate(p_dl, pl_clients, cfg.noise_w)
    r_ul = base_rate(p_ul, pl_clients, cfg.noise_w)

    alpha = size_mbit / r_dl + size_mbit / r_ul
    alpha_ul = size_mbit / r_ul
    t_comp = t_local + cfg.t_global
    alpha = torch.where(mask, alpha, 0.0).to(torch.float32)
    alpha_ul = torch.where(mask, alpha_ul, 0.0).to(torch.float32)
    t_comp = torch.where(mask, t_comp, 0.0).to(torch.float32)

    svc = ServiceSet(alpha=alpha, t_comp=t_comp, mask=mask, alpha_ul=alpha_ul)
    meta = {
        "client_counts": client_counts,
        "pathloss_db": pl_clients,
        "size_mbit": size_mbit,
        "r_dl": r_dl,
        "r_ul": r_ul,
        "p_ul": p_ul,
        "p_dl": p_dl,
        "t_local": t_local,
    }
    return svc, meta


class ServiceDraws(NamedTuple):
    """The raw draws of one period's service set: the inputs of
    ``services_from_draws`` in its argument order.  A channel process that
    rebuilds the set (``Process.rebuilds``) swaps the path-loss normals and
    keeps every other draw."""

    client_counts: torch.Tensor  # (N,) int32
    k_max: int
    eps_service: torch.Tensor    # (N, 1) standard normal
    eps_client: torch.Tensor     # (N, K) standard normal
    size_mbit: torch.Tensor      # (N, 1)
    p_ul: torch.Tensor           # (N, K)
    p_dl: torch.Tensor           # (N, 1)
    t_local: torch.Tensor        # (N, K)


def channel_innovations(generator: torch.Generator, n_services: int,
                        k_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The standard-normal path-loss draws ``(eps_service (N, 1),
    eps_client (N, K))``: the first draws ``sample_draws`` takes from its
    generator once the client counts are known, so the one definition of
    them."""
    dev = generator.device
    return (torch.randn((n_services, 1), generator=generator, device=dev),
            torch.randn((n_services, k_max), generator=generator, device=dev))


def sample_draws(generator: torch.Generator, n_services: int,
                 cfg: NetworkConfig = NetworkConfig(),
                 k_max: int | None = None,
                 client_counts: torch.Tensor | None = None) -> ServiceDraws:
    """Draw a period's raw service parameters per §VI.A on the generator's
    device (client counts first when not given, then the path-loss
    normals, sizes, powers and compute times)."""
    if client_counts is None:
        client_counts = sample_client_counts(generator, n_services, cfg)
    client_counts = torch.as_tensor(client_counts, dtype=torch.int32,
                                    device=generator.device)
    if k_max is None:
        k_max = int(torch.max(client_counts))
    shape = (n_services, k_max)
    eps_service, eps_client = channel_innovations(generator, n_services, k_max)
    return ServiceDraws(
        client_counts, k_max, eps_service, eps_client,
        _uniform(generator, (n_services, 1), cfg.model_mbit_lo,
                 cfg.model_mbit_hi),
        _uniform(generator, shape, cfg.p_ul_lo, cfg.p_ul_hi),
        _uniform(generator, (n_services, 1), cfg.p_dl_lo, cfg.p_dl_hi),
        _uniform(generator, shape, cfg.t_local_lo, cfg.t_local_hi))


def sample_services(
    generator: torch.Generator,
    n_services: int,
    cfg: NetworkConfig = NetworkConfig(),
    k_max: int | None = None,
    client_counts: torch.Tensor | None = None,
    channel_normals: tuple[torch.Tensor, torch.Tensor] | None = None,
    extra_pathloss_db: torch.Tensor | None = None,
) -> tuple[ServiceSet, dict]:
    """Draw a padded batch of services per §VI.A on the generator's device.
    Returns (ServiceSet, meta).

    ``channel_normals`` replaces the path-loss standard normals (the pair
    ``channel_innovations`` draws) with externally evolved ones;
    ``extra_pathloss_db`` is an additive (N, K) dB term on top (fast
    fading).  Every other draw stays on the same generator stream, so both
    hooks perturb only the channel."""
    draws = sample_draws(generator, n_services, cfg, k_max, client_counts)
    if channel_normals is not None:
        draws = draws._replace(eps_service=channel_normals[0],
                               eps_client=channel_normals[1])
    return services_from_draws(*draws, cfg,
                               extra_pathloss_db=extra_pathloss_db)
