"""FL services: the paper abstracts a service to the tuple
<s^DT, {w^LC_k}, s^UT, w^GC> (§III.A).  ``arch_service_tuple`` derives it
from an architecture config: download and upload payloads from the
parameter footprint (optionally compressed), local work from the training
step's FLOPs, aggregation work from the averaging cost.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import RawServiceParams
from repro_torch.models.config import ModelConfig

MBIT = 1e6


@dataclasses.dataclass
class FLService:
    """One service slot of a co-simulated episode: its static draws and
    its final counters (``episode_services``)."""

    service_id: int
    n_clients: int
    rounds_required: int          # termination criterion (rounds to converge)
    rounds_done: int = 0
    periods_active: int = 0
    arrived_period: int = 0

    @property
    def finished(self) -> bool:
        return self.rounds_done >= self.rounds_required


def episode_services(arrivals, counts, rounds_done, durations,
                     rounds_required: int) -> list[FLService]:
    """One ``FLService`` per slot from an episode's static draws ((N,)
    arrival periods and client counts) and final counters."""
    return [
        FLService(service_id=i, n_clients=int(counts[i]),
                  rounds_required=int(rounds_required),
                  rounds_done=int(rounds_done[i]),
                  periods_active=int(durations[i]),
                  arrived_period=int(arrivals[i]))
        for i in range(len(arrivals))
    ]


def model_bits(cfg: ModelConfig, weight_bits: int = 32,
               active_only: bool = False) -> float:
    n = cfg.active_param_count() if active_only else cfg.param_count()
    return float(n) * weight_bits


def train_flops_per_token(cfg: ModelConfig) -> float:
    """6 N_active per token (forward and backward)."""
    return 6.0 * float(cfg.active_param_count())


def arch_service_tuple(cfg: ModelConfig, *, r_dl: torch.Tensor,
                       r_ul: torch.Tensor, client_flops,
                       server_flops: float = 1e12,
                       tokens_per_round: int = 8192, local_epochs: int = 1,
                       weight_bits: int = 32,
                       uplink_compression: float = 1.0) -> RawServiceParams:
    """The paper's service tuple for an architecture.

    ``r_dl``/``r_ul``: per-client base rates (bit/s/Hz); ``client_flops``:
    per-client compute speeds (FLOP/s).  Payloads are in Mbit.
    ``uplink_compression`` is the static s^UT multiplier
    (``compression.compression_ratio``), in (0, 1]."""
    if not 0.0 < uplink_compression <= 1.0:
        raise ValueError(
            f"uplink_compression must be in (0, 1] (compressing can never "
            f"grow s^UT past dense -- use fl.compression.compression_ratio, "
            f"which clamps), got {uplink_compression}")
    bits = model_bits(cfg, weight_bits)
    w_lc = train_flops_per_token(cfg) * tokens_per_round * local_epochs
    t_local = w_lc / torch.as_tensor(client_flops)
    w_gc = float(cfg.param_count()) * r_dl.shape[0]  # averaging adds
    return RawServiceParams(
        s_dl_mbit=float(bits / MBIT),
        s_ul_mbit=float(bits * uplink_compression / MBIT),
        r_dl=r_dl, r_ul=r_ul, t_local=t_local,
        t_global=w_gc / server_flops)
