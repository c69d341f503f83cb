"""Multi-period wireless-network simulator (paper §VI.D long-term setting).

Services arrive via a Poisson process, live for ``rounds_required`` FL
rounds, and exit on completion.  Each period the active set is re-allocated
bandwidth by the selected policy.

``run_scan`` is the episode engine.  The episode state lives in a
fixed-capacity ServiceSet (capacity ``n_services_total``): a service that
has not arrived yet or has already finished is an all-masked row
(``types.mask_inactive``), so arrivals and departures are mask flips and
every period runs the same shapes.  The period loop is a Python loop that
stops after the period in which every service finished; per period it
waits on the host twice: for that stopping test, and (warm ``coop``) for
the solver's non-finite rescue test.

Randomness comes from explicit ``torch.Generator``s seeded from
``cfg.seed``: the episode-static arrivals and client counts
(``_static_draws``) and, per period, the service set drawn by
``sampler(period)``.  A caller may pass its own ``sampler`` (and its own
``arrivals``/``counts``), which is how a test feeds the reference
package's draws through this engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import network, policy as policy_mod
from repro_torch.core.types import (ServiceSet, default_device, mask_clients,
                                    mask_inactive, scale_uplink)

# Salts of the generator streams, so no two draws share a seed.
_DRAW_SALT = (1 << 30) + 3      # episode-static arrivals + client counts
_INIT_SALT = 1 << 30            # scenario-process initial state
_SCENARIO_SALT = (1 << 30) + 1  # per-period scenario-process steps

_AGG_KEYS = ("freq_sum", "objective", "n_active", "n_clients")


@dataclasses.dataclass
class SimConfig:
    policy: str = "coop"
    n_services_total: int = 10
    rounds_required: int = 2000
    p_arrive: float = 5.0              # mean arrival interval in periods
    mean_clients: float = 25.0
    var_clients: float = 15.0
    mean_channel_db: float = 85.0
    var_channel_db: float = 15.0
    n_bids: int = 5
    alpha_fair: float = 0.5
    max_periods: int = 4000
    seed: int = 0
    intra_backend: str = "reference"   # "reference" | "pallas" | "megakernel"
    k_max: int | None = None           # client-capacity pad; None -> derived
    # Warm-start the allocation across periods (coop's dual price).
    warm_start: bool = False
    # When False the episode keeps only scalar aggregates, no history.
    collect_history: bool = True
    # When True (requires collect_history) the history also stacks the
    # per-period allocation record: b, f, active, rounds.
    collect_alloc: bool = False
    channel_process: str | scenarios.ScenarioSpec = "iid"
    arrival_process: str | scenarios.ScenarioSpec = "poisson"
    churn_process: str | scenarios.ScenarioSpec = "none"


def _default_net(cfg: SimConfig) -> network.NetworkConfig:
    return network.NetworkConfig(
        mean_clients=cfg.mean_clients, var_clients=cfg.var_clients,
        mean_pathloss_db=cfg.mean_channel_db, var_pathloss_db=cfg.var_channel_db,
    )


def _k_cap(cfg: SimConfig) -> int:
    """Seed-independent client-capacity pad: mean + 5 sigma (counts are
    clipped into it)."""
    if cfg.k_max is not None:
        return cfg.k_max
    return int(np.ceil(cfg.mean_clients + 5.0 * np.sqrt(max(cfg.var_clients, 0.0))))


def _generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from a hash of ``words``."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _static_draws(cfg: SimConfig, net: network.NetworkConfig
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Episode-static randomness: (n_services_total,) arrival periods and
    client counts (a clipped normal, fixed at arrival), drawn on the host."""
    gen = _generator("cpu", cfg.seed + 7, _DRAW_SALT)
    draw = scenarios.get_arrival(cfg.arrival_process)
    arrivals = draw(gen, cfg.n_services_total, cfg.p_arrive)
    std = np.sqrt(max(cfg.var_clients, 1e-9))
    eps = torch.randn((cfg.n_services_total,), generator=gen)
    counts = torch.clamp(torch.round(cfg.mean_clients + std * eps),
                         net.k_min, _k_cap(cfg))
    return arrivals.numpy().astype(np.int64), counts.numpy().astype(np.int64)


def default_sampler(cfg: SimConfig, net: network.NetworkConfig, counts,
                    device) -> Callable[[int], ServiceSet]:
    """The per-period service sets of an episode: ``sample_services`` on a
    generator seeded from (cfg.seed, period), on ``device``."""
    counts_t = torch.as_tensor(np.asarray(counts), dtype=torch.int32,
                               device=device)
    k_max = _k_cap(cfg)

    def sampler(period: int) -> ServiceSet:
        gen = _generator(device, cfg.seed + 7, period)
        svc, _ = network.sample_services(gen, cfg.n_services_total, net,
                                         k_max=k_max, client_counts=counts_t)
        return svc

    return sampler


# ---------------------------------------------------------------------------
# The shared per-period step.
# ---------------------------------------------------------------------------

def _period_step(rounds_done, duration, chan_state, churn_state, pol_state,
                 period, arrivals, svc_full, generator, extra_avail=None,
                 ul_comp=None, *, policy_fn, chan_step, churn_step, net,
                 rounds_required: int):
    """One period: evolve channels and churn, flip activity masks, allocate.

    ``svc_full`` is the period's sampled set; ``generator`` drives the
    scenario processes.  ``extra_avail`` is an optional (N, K) bool
    availability mask applied on top of churn, ``ul_comp`` an optional (N,)
    uplink-compression multiplier applied before the policy.  Returns the
    new carry, the scalar ``stats`` and ``extras``, the period's allocation
    record (masked set, b, f, active, rounds before the clamp).
    """
    chan_state, svc_full = chan_step(generator, chan_state, svc_full)
    churn_state, svc_full = churn_step(generator, churn_state, svc_full)
    if extra_avail is not None:
        svc_full = mask_clients(svc_full, extra_avail)
    if ul_comp is not None:
        svc_full = scale_uplink(svc_full, ul_comp)
    active = torch.logical_and(arrivals <= period, rounds_done < rounds_required)
    svc = mask_inactive(svc_full, active)
    b, f, pol_state = policy_fn(svc, net.total_bandwidth_mhz, pol_state)
    # A non-finite frequency must not corrupt the integer rounds carry.
    f_rounds = torch.where(torch.isfinite(f), f, 0.0)
    rounds = torch.clamp(torch.floor(f_rounds * net.period_s), min=0.0
                         ).to(torch.int32)
    rounds_done = torch.clamp(
        rounds_done + torch.where(active, rounds, 0), max=rounds_required)
    duration = duration + active.to(torch.int32)
    stats = {
        "freq_sum": torch.sum(f),
        "objective": torch.sum(torch.log1p(f)),
        "n_active": torch.sum(active.to(torch.int32)),
        "n_clients": torch.sum(svc.mask.to(torch.int32)),
        "all_done": torch.all(rounds_done >= rounds_required),
    }
    extras = {"svc": svc, "b": b, "f": f, "active": active, "rounds": rounds}
    return (rounds_done, duration, chan_state, churn_state, pol_state, stats,
            extras)


def _summarize(cfg: SimConfig, rounds_done, duration, history: list[dict],
               fallbacks: int) -> dict:
    """The summary ``repro.fl.simulator.run_scan`` returns, from the
    per-period stats of the periods that ran (up to and including the one in
    which every service finished), plus ``fallbacks``: in how many periods
    the warm solver served its cold-bisection rescue."""
    duration = duration.cpu().numpy()
    finished = bool(np.all(rounds_done.cpu().numpy() >= cfg.rounds_required))
    out = {
        "avg_duration": float(np.mean(duration)),
        "std_duration": float(np.std(duration)),
        "durations": [int(d) for d in duration],
        "periods": len(history),
        "finished": finished,
        "fallbacks": fallbacks,
    }
    stacked = {k: torch.stack([h[k] for h in history]).cpu().numpy()
               for k in history[0] if k != "all_done"}
    if cfg.collect_history:
        out["history"] = stacked
    else:
        out["history"] = None
        out["totals"] = {k: float(np.sum(stacked[k])) for k in _AGG_KEYS}
    return out


def run_scan(cfg: SimConfig, net: network.NetworkConfig | None = None, *,
             arrivals=None, counts=None, avail=None,
             sampler: Callable[[int], ServiceSet] | None = None,
             device=None) -> dict:
    """Simulate one episode.  Returns avg_duration, std_duration, durations,
    periods, finished, fallbacks, and the per-period history as stacked
    numpy arrays (``totals`` instead when ``collect_history`` is False).

    ``arrivals``/``counts`` replace the episode-static draws with an explicit
    (n_services_total,) admission trace; ``avail`` adds a
    (max_periods, n_services_total, k_max) bool availability stream;
    ``sampler(period) -> ServiceSet`` replaces the per-period draws.  The
    episode runs on ``device`` (default: the card).
    """
    device = torch.device(device) if device is not None else default_device()
    net = net or _default_net(cfg)
    if (arrivals is None) != (counts is None):
        raise ValueError("pass arrivals and counts together (or neither)")
    if cfg.collect_alloc and not cfg.collect_history:
        raise ValueError(
            "collect_alloc stacks the per-period allocation stream into the "
            "history, so it requires collect_history=True")
    if arrivals is None:
        arrivals, counts = _static_draws(cfg, net)
    n, k_max = cfg.n_services_total, _k_cap(cfg)
    if avail is not None:
        avail = torch.as_tensor(np.asarray(avail), dtype=torch.bool,
                                device=device)
        want = (cfg.max_periods, n, k_max)
        if tuple(avail.shape) != want:
            raise ValueError(
                f"avail must have shape (max_periods, n_services_total, "
                f"k_max) = {want}, got {tuple(avail.shape)}")
    if sampler is None:
        sampler = default_sampler(cfg, net, counts, device)

    pol = policy_mod.get_stateful_policy(
        cfg.policy, warm_start=cfg.warm_start, n_bids=cfg.n_bids,
        alpha_fair=cfg.alpha_fair, intra_backend=cfg.intra_backend)
    chan = scenarios.get_channel(cfg.channel_process, net)
    churn = scenarios.get_churn(cfg.churn_process, net)
    init_gen = _generator(device, cfg.seed + 7, _INIT_SALT)
    chan_state = chan.init(init_gen, n, k_max)
    churn_state = churn.init(init_gen, n, k_max)
    pol_state = pol.init_state(n, device)

    arrivals_t = torch.as_tensor(np.asarray(arrivals), dtype=torch.int32,
                                 device=device)
    rounds_done = torch.zeros((n,), dtype=torch.int32, device=device)
    duration = torch.zeros((n,), dtype=torch.int32, device=device)
    history = []
    for period in range(cfg.max_periods):
        svc_full = sampler(period)
        if (svc_full.device.type != device.type
                or svc_full.alpha.shape != (n, k_max)):
            raise ValueError(
                f"sampler({period}) gave a {tuple(svc_full.alpha.shape)} set "
                f"on {svc_full.device}; the episode needs ({n}, {k_max}) on "
                f"{device}")
        (rounds_done, duration, chan_state, churn_state, pol_state, stats,
         extras) = _period_step(
            rounds_done, duration, chan_state, churn_state, pol_state, period,
            arrivals_t, svc_full,
            _generator(device, cfg.seed + 7, period, _SCENARIO_SALT),
            None if avail is None else avail[period],
            policy_fn=pol.step, chan_step=chan.step, churn_step=churn.step,
            net=net, rounds_required=cfg.rounds_required)
        if cfg.collect_alloc:
            stats.update(b=extras["b"], f=extras["f"],
                         active=extras["active"], rounds=extras["rounds"])
        history.append(stats)
        if bool(stats["all_done"]):
            break
    return _summarize(cfg, rounds_done, duration, history,
                      policy_mod.fallback_count(pol_state))
