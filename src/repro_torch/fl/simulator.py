"""Multi-period wireless-network simulator (paper §VI.D long-term setting).

Services arrive via an arrival process, live for ``rounds_required`` FL
rounds, and exit on completion.  Each period the active set is
re-allocated bandwidth by the selected policy.

``run_scan`` is the episode engine.  The episode state lives in a
fixed-capacity ServiceSet (capacity ``n_services_total``): a service that
has not arrived yet or has already finished is an all-masked row
(``types.mask_inactive``), so arrivals and departures are mask flips and
every period runs the same shapes.  The period loop is a Python loop that
stops after the period in which every service finished; per period it
waits on the host twice: for that stopping test, and (warm ``coop``) for
the solver's non-finite rescue test.  ``run_batch`` runs one such episode
per seed, each with its own warm state, and stacks the summaries as the
JAX package's vmapped ``run_batch`` does.  ``run_fleet`` walks a fleet of
seeds a chunk at a time (``fleet_geometry``), each chunk as ``run_batch``
runs it, its outputs on the host before the next chunk starts.  ``run``
is the legacy checkpointable engine: a per-period loop over the same
period step with plain-dict (JSON) state, resumable after a crash.

Randomness comes from explicit ``torch.Generator``s seeded from
``cfg.seed``: the episode-static arrivals and client counts
(``_static_draws``) and, per period, what ``sampler(period)`` gives: the
period's raw service draws and the draw source of the scenario processes
(``PeriodDraws``).  A caller may pass its own ``sampler`` (and its own
``arrivals``/``counts``), which is how a test feeds the reference
package's draws through this engine.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import scenarios, tree
from repro_torch.core import network, policy as policy_mod
from repro_torch.core.types import (ServiceSet, default_device, mask_clients,
                                    mask_inactive, scale_uplink)
from repro_torch.scenarios import GeneratorSource, generator

# Salt of the episode-static draws (arrivals + client counts), above every
# period number and the scenario salts, so no two draws share a seed; the
# client counts add their own word.  Without it they drew from
# generator(seed + 7, _DRAW_SALT), which is the arrival source's "gaps"
# stream (words zero-padded, see scenarios.generator): the counts and the
# gaps came from one sequence of uniforms, correlated (ROADMAP C4).
_DRAW_SALT = (1 << 30) + 3
_COUNTS_SALT = (1 << 30) + 4

# Default chunk of run_fleet (the reference's: its (chunk, N, K) solver
# working set stays cache-resident).
FLEET_CHUNK = 64
# The fleet's one mesh axis, by the reference's name.
FLEET_AXIS = "seeds"

# Version tag of this package's draw streams, written into the legacy
# engine's snapshots.  A resume re-derives the arrivals, counts and every
# period's draws from cfg.seed, so a snapshot written under another stream
# (the reference package's threefry draws are "device/v1") would continue
# with other arrivals than the ones behind its progress: it is refused.
DRAW_STREAM = "torch-cpu/v1"

_AGG_KEYS = ("freq_sum", "objective", "n_active", "n_clients")
# The dtypes of the reference's stacked history.
_HISTORY_DTYPES = {"freq_sum": np.float32, "objective": np.float32,
                   "n_active": np.int32, "n_clients": np.int32,
                   "all_done": np.bool_, "b": np.float32, "f": np.float32,
                   "active": np.bool_, "rounds": np.int32}


class PeriodDraws(NamedTuple):
    """What a sampler gives for one period.

    ``services``: the period's raw draws (``network.ServiceDraws``), or an
    already built ServiceSet (not for a channel process that rebuilds the
    set); ``source``: the scenario processes' draws of the period;
    ``init``: the draws of their initial states, read at period 0 only
    (None: the engine's own, seeded from ``cfg.seed``).
    """

    services: network.ServiceDraws | ServiceSet
    source: scenarios.Source
    init: scenarios.Source | None = None


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


def _static_draws(cfg: SimConfig, net: network.NetworkConfig
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Episode-static randomness: (n_services_total,) arrival periods and
    client counts (a clipped normal, fixed at arrival), drawn on the host."""
    draw = scenarios.get_arrival(cfg.arrival_process)
    arrivals = draw(GeneratorSource("cpu", cfg.seed + 7, _DRAW_SALT),
                    cfg.n_services_total, cfg.p_arrive)
    std = np.sqrt(max(cfg.var_clients, 1e-9))
    eps = torch.randn((cfg.n_services_total,), generator=generator(
        cfg.seed + 7, _DRAW_SALT, _COUNTS_SALT))
    counts = torch.clamp(torch.round(cfg.mean_clients + std * eps),
                         net.k_min, _k_cap(cfg))
    return arrivals.numpy().astype(np.int64), counts.numpy().astype(np.int64)


def _raw_draws(cfg: SimConfig, net: network.NetworkConfig, counts
               ) -> Callable[[int], network.ServiceDraws]:
    """``period`` -> the period's raw service draws on the CPU, from a
    generator seeded from (cfg.seed, period) alone."""
    counts_t = torch.as_tensor(np.array(counts), dtype=torch.int32)
    k_max = _k_cap(cfg)

    def draw(period: int) -> network.ServiceDraws:
        return network.sample_draws(generator(cfg.seed + 7, period),
                                    cfg.n_services_total, net, k_max=k_max,
                                    client_counts=counts_t)

    return draw


def _placed(raw: network.ServiceDraws, cfg: SimConfig, period: int,
            device) -> PeriodDraws:
    """A period's CPU draws moved to ``device``, with the scenario draws of
    (cfg.seed, period, stream) and, at period 0, the initial states' of
    (cfg.seed, stream)."""
    raw = network.ServiceDraws(*(x.to(device) if torch.is_tensor(x) else x
                                 for x in raw))
    words = (cfg.seed + 7,)
    return PeriodDraws(raw, GeneratorSource(device, *words, period),
                       GeneratorSource(device, *words) if period == 0
                       else None)


def default_sampler(cfg: SimConfig, net: network.NetworkConfig, counts,
                    device) -> Callable[[int], PeriodDraws]:
    """The per-period draws of an episode on ``device``: ``sample_draws`` on
    a generator seeded from (cfg.seed, period), the scenario draws from
    (cfg.seed, period, stream), the initial states' from (cfg.seed,
    stream).  Every draw is made on the CPU and then moved to ``device``,
    so one seed runs the same episode on every device.  Each call draws
    its period inline; an engine given no ``sampler`` draws the same
    periods ahead where they are large (``_PrefetchingSampler``)."""
    draw = _raw_draws(cfg, net, counts)
    return lambda period: _placed(draw(period), cfg, period, device)


# Given no sampler, the engine draws the next PREFETCH_DEPTH periods'
# services on PREFETCH_WORKERS host threads while the device runs the
# current one, once a period holds PREFETCH_MIN_SLOTS (service, client)
# slots or more.  Measured on an H100 machine's host (PERF.md): a market
# period (8192 x 45 slots, 1.1 M floats) takes 9-18 ms of one thread to
# draw, a warm coop period 2-4 ms of the engine, so several periods are
# drawn at once (one generator is serial).  But the threads also slow the
# engine's own thread, by ~1 ms a period at the paper's setting (10 x 45
# slots, ~0.1 ms of draws), likely in handing the interpreter lock back
# and forth: there the engine draws inline.
PREFETCH_WORKERS = max(1, min(6, (os.cpu_count() or 1) - 2))
PREFETCH_DEPTH = 2 * PREFETCH_WORKERS
PREFETCH_MIN_SLOTS = 1 << 15


class _PrefetchingSampler:
    """``default_sampler``'s draws, bit for bit, with the raw service draws
    made ahead on host threads: every period draws from its own generator,
    so the order in which the threads run changes nothing.  The copy to
    the device stays on the calling thread, on its current stream.  (The
    threads do not pin the draws: at market scale the episode is bound by
    the draws' throughput, where a non-blocking copy gained nothing, and
    the process's first pinned allocation took 0.25 s or more; PERF.md.)
    ``waits`` holds the seconds each call waited for its period's draws,
    in call order.  ``close`` cancels the draws still pending and joins
    the threads; the engine calls it however the episode ends."""

    def __init__(self, cfg: SimConfig, net: network.NetworkConfig, counts,
                 device):
        self._draw = _raw_draws(cfg, net, counts)
        self._cfg, self._device = cfg, device
        self._last = cfg.max_periods - 1
        self._pool = ThreadPoolExecutor(PREFETCH_WORKERS,
                                        thread_name_prefix="repro-draws")
        self._pending: dict[int, Future] = {}
        self.waits: list[float] = []

    def __call__(self, period: int) -> PeriodDraws:
        for ahead in range(period, min(period + PREFETCH_DEPTH,
                                       self._last) + 1):
            if ahead not in self._pending:
                self._pending[ahead] = self._pool.submit(self._draw, ahead)
        t0 = time.perf_counter()
        try:
            raw = self._pending.pop(period).result()
        except Exception as exc:
            raise RuntimeError(f"drawing period {period}'s services failed: "
                               f"{exc!r}") from exc
        self.waits.append(time.perf_counter() - t0)
        return _placed(raw, self._cfg, period, self._device)

    def close(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# The shared per-period step.
# ---------------------------------------------------------------------------

def _period_step(rounds_done, duration, chan_state, churn_state, pol_state,
                 period, arrivals, draws: PeriodDraws, extra_avail=None,
                 ul_comp=None, *, policy_fn, chan_step, churn_step,
                 chan_rebuilds: bool, net, rounds_required: int):
    """One period: evolve channels and churn, flip activity masks, allocate.

    ``draws`` is the period's ``PeriodDraws``: a rebuilding channel process
    builds the set from its raw draws, any other is handed the set built
    from them.  ``extra_avail`` is an optional (N, K) bool availability
    mask applied on top of churn, ``ul_comp`` an optional (N,)
    uplink-compression multiplier applied before the policy.  Returns the
    new carry, the scalar ``stats`` and ``extras``, the period's allocation
    record (masked set, b, f, active, rounds before the clamp).
    """
    if chan_rebuilds:
        chan_state, svc_full = chan_step(draws.source, chan_state,
                                         draws.services)
    else:
        svc_full = draws.services
        if not isinstance(svc_full, ServiceSet):
            svc_full, _ = network.services_from_draws(*svc_full, net)
        chan_state, svc_full = chan_step(draws.source, chan_state, svc_full)
    churn_state, svc_full = churn_step(draws.source, churn_state, svc_full)
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


class _Episode(NamedTuple):
    rounds_done: np.ndarray     # (N,) int32
    duration: np.ndarray        # (N,) int32
    history: dict               # key -> (periods run, ...) numpy stack
    fallbacks: int


def _check_draws(draws, period: int, n: int, k_max: int, device,
                 rebuilds: bool, channel) -> PeriodDraws:
    if isinstance(draws, ServiceSet):
        draws = PeriodDraws(draws, None)
    services = draws.services
    if isinstance(services, ServiceSet):
        if rebuilds:
            raise ValueError(
                f"channel process {scenarios.as_spec(channel, 'iid').name!r} "
                f"rebuilds the set from the period's raw draws, but "
                f"sampler({period}) gave a built ServiceSet")
        shape, dev = tuple(services.alpha.shape), services.device
    else:
        shape, dev = tuple(services.eps_client.shape), services.eps_client.device
    if dev.type != device.type or shape != (n, k_max):
        raise ValueError(
            f"sampler({period}) gave a {shape} set on {dev}; the episode "
            f"needs ({n}, {k_max}) on {device}")
    return draws


def _episode_sampler(cfg: SimConfig, net: network.NetworkConfig, counts,
                     sampler, device):
    """(sampler, own): the caller's sampler, or given none the engine's
    own, which draws large periods ahead on host threads (``own``, to be
    closed however the episode ends; None where the engine draws
    inline)."""
    if sampler is not None:
        return sampler, None
    if cfg.n_services_total * _k_cap(cfg) >= PREFETCH_MIN_SLOTS:
        own = _PrefetchingSampler(cfg, net, counts, device)
        return own, own
    return default_sampler(cfg, net, counts, device), None


def _period_draws(sampler, period: int, cfg: SimConfig, device,
                  channel) -> PeriodDraws:
    """``sampler(period)`` checked, with the engine's own scenario source
    where the sampler gave none."""
    draws = _check_draws(sampler(period), period, cfg.n_services_total,
                         _k_cap(cfg), device, channel.rebuilds,
                         cfg.channel_process)
    if draws.source is None:
        draws = draws._replace(
            source=GeneratorSource(device, cfg.seed + 7, period))
    return draws


def _run_episode(cfg: SimConfig, net: network.NetworkConfig, arrivals,
                 counts, avail, sampler, device) -> _Episode:
    """The period loop of one episode, up to and including the period in
    which every service finished (or ``max_periods``)."""
    n, k_max = cfg.n_services_total, _k_cap(cfg)
    if avail is not None:
        avail = torch.as_tensor(np.asarray(avail), dtype=torch.bool,
                                device=device)
        want = (cfg.max_periods, n, k_max)
        if tuple(avail.shape) != want:
            raise ValueError(
                f"avail must have shape (max_periods, n_services_total, "
                f"k_max) = {want}, got {tuple(avail.shape)}")
    pol = policy_mod.get_stateful_policy(
        cfg.policy, warm_start=cfg.warm_start, n_bids=cfg.n_bids,
        alpha_fair=cfg.alpha_fair, intra_backend=cfg.intra_backend)
    chan = scenarios.get_channel(cfg.channel_process, net)
    churn = scenarios.get_churn(cfg.churn_process, net)
    pol_state = pol.init_state(n, device)

    arrivals_t = torch.as_tensor(np.array(arrivals), dtype=torch.int32,
                                 device=device)
    rounds_done = torch.zeros((n,), dtype=torch.int32, device=device)
    duration = torch.zeros((n,), dtype=torch.int32, device=device)
    history = []
    sampler, own = _episode_sampler(cfg, net, counts, sampler, device)
    try:
        for period in range(cfg.max_periods):
            draws = _period_draws(sampler, period, cfg, device, chan)
            if period == 0:
                init = draws.init or GeneratorSource(device, cfg.seed + 7)
                chan_state = chan.init(init, n, k_max)
                churn_state = churn.init(init, n, k_max)
            (rounds_done, duration, chan_state, churn_state, pol_state,
             stats, extras) = _period_step(
                rounds_done, duration, chan_state, churn_state, pol_state,
                period, arrivals_t, draws,
                None if avail is None else avail[period],
                policy_fn=pol.step, chan_step=chan.step,
                churn_step=churn.step, chan_rebuilds=chan.rebuilds, net=net,
                rounds_required=cfg.rounds_required)
            if cfg.collect_alloc:
                stats.update(b=extras["b"], f=extras["f"],
                             active=extras["active"],
                             rounds=extras["rounds"])
            history.append(stats)
            if bool(stats["all_done"]):
                break
    finally:
        if own is not None:
            own.close()
    stacked = {k: torch.stack([h[k] for h in history]).cpu().numpy()
               for k in history[0]}
    return _Episode(rounds_done.cpu().numpy(), duration.cpu().numpy(),
                    stacked, policy_mod.fallback_count(pol_state))


def _check_run_inputs(cfg: SimConfig, arrivals, counts) -> None:
    if (arrivals is None) != (counts is None):
        raise ValueError("pass arrivals and counts together (or neither)")
    if cfg.collect_alloc and not cfg.collect_history:
        raise ValueError(
            "collect_alloc stacks the per-period allocation stream into the "
            "history, so it requires collect_history=True")


def _totals(history: dict) -> dict:
    """The aggregate-only mode's sums over the periods that ran, added in
    order in the reference's dtypes, as its aggregate carry adds them."""
    out = {}
    for key in _AGG_KEYS:
        dtype = _HISTORY_DTYPES[key]
        total = np.zeros((), dtype)
        for v in history[key].astype(dtype):
            total = (total + v).astype(dtype)
        out[key] = total
    return out


def run_scan(cfg: SimConfig, net: network.NetworkConfig | None = None, *,
             arrivals=None, counts=None, avail=None,
             sampler: Callable[[int], PeriodDraws | ServiceSet] | None = None,
             device=None) -> dict:
    """Simulate one episode.  Returns avg_duration, std_duration, durations,
    periods, finished, fallbacks, and the per-period history as stacked
    numpy arrays (``totals`` instead when ``collect_history`` is False).

    ``arrivals``/``counts`` replace the episode-static draws with an explicit
    (n_services_total,) admission trace; ``avail`` adds a
    (max_periods, n_services_total, k_max) bool availability stream;
    ``sampler(period)`` replaces the per-period draws: a ``PeriodDraws``,
    or a built ServiceSet (then the scenario processes draw from the
    engine's own source).  The episode runs on ``device`` (default: the
    card).
    """
    device = torch.device(device) if device is not None else default_device()
    net = net or _default_net(cfg)
    _check_run_inputs(cfg, arrivals, counts)
    if arrivals is None:
        arrivals, counts = _static_draws(cfg, net)
    ep = _run_episode(cfg, net, arrivals, counts, avail, sampler, device)
    out = {
        "avg_duration": float(np.mean(ep.duration)),
        "std_duration": float(np.std(ep.duration)),
        "durations": [int(d) for d in ep.duration],
        "periods": len(ep.history["all_done"]),
        "finished": bool(np.all(ep.rounds_done >= cfg.rounds_required)),
        "fallbacks": ep.fallbacks,
    }
    stacked = {k: v for k, v in ep.history.items() if k != "all_done"}
    if cfg.collect_history:
        out["history"] = stacked
    else:
        out["history"] = None
        out["totals"] = {k: float(v) for k, v in _totals(stacked).items()}
    return out


def run_batch(cfg: SimConfig, seeds, net: network.NetworkConfig | None = None,
              *, arrivals=None, counts=None, samplers=None,
              device=None) -> dict:
    """One episode per seed (``cfg`` with ``seed`` replaced), each with its
    own warm state, stacked as the reference's vmapped ``run_batch``:
    seeds, avg_duration (S,), std_duration (S,), durations (S, N),
    finished (S,), and the history with every series (``all_done``
    included) at its full ``max_periods`` length, the periods after an
    episode stopped holding what the reference's scan computes there
    (nothing active, nothing allocated, ``all_done`` True); or, without
    ``collect_history``, ``periods`` (S,) and ``totals``.  Also
    ``fallbacks`` (S,): warm-solver rescues per episode.

    ``arrivals``/``counts`` are (S, N) admission traces, ``samplers`` one
    per seed (see ``run_scan``).
    """
    device = torch.device(device) if device is not None else default_device()
    net = net or _default_net(cfg)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_batch needs at least one seed")
    _check_run_inputs(cfg, arrivals, counts)
    if samplers is not None and len(samplers) != len(seeds):
        raise ValueError(f"got {len(samplers)} samplers for {len(seeds)} "
                         f"seeds")
    if arrivals is not None:
        arrivals, counts = np.asarray(arrivals), np.asarray(counts)
        want = (len(seeds), cfg.n_services_total)
        if arrivals.shape != want or counts.shape != want:
            raise ValueError(f"arrivals and counts must be (seeds, "
                             f"n_services_total) = {want}, got "
                             f"{arrivals.shape} and {counts.shape}")
    episodes = []
    for i, seed in enumerate(seeds):
        cfg_i = dataclasses.replace(cfg, seed=seed)
        arr, cnt = ((arrivals[i], counts[i]) if arrivals is not None
                    else _static_draws(cfg_i, net))
        episodes.append(_run_episode(
            cfg_i, net, arr, cnt, None,
            None if samplers is None else samplers[i], device))
    duration = np.stack([ep.duration for ep in episodes]).astype(np.int32)
    rounds_done = np.stack([ep.rounds_done for ep in episodes])
    out = {
        "seeds": seeds,
        "avg_duration": duration.mean(axis=1),
        "std_duration": duration.std(axis=1),
        "durations": duration,
        "finished": np.all(rounds_done >= cfg.rounds_required, axis=1),
        "fallbacks": np.array([ep.fallbacks for ep in episodes]),
    }
    if cfg.collect_history:
        out["history"] = {
            k: np.stack([_pad_history(ep.history[k], k, cfg.max_periods)
                         for ep in episodes])
            for k in episodes[0].history}
    else:
        out["history"] = None
        out["periods"] = np.array([len(ep.history["all_done"])
                                   for ep in episodes], np.int32)
        totals = [_totals(ep.history) for ep in episodes]
        out["totals"] = {k: np.stack([t[k] for t in totals])
                         for k in _AGG_KEYS}
    return out


def _pad_history(x: np.ndarray, key: str, max_periods: int) -> np.ndarray:
    """A series of the periods that ran, in the reference's dtype, extended
    to ``max_periods`` with the periods after every service finished: all
    zero (no service active, b = f = 0, no clients, no rounds) but
    ``all_done``, which stays True."""
    x = x.astype(_HISTORY_DTYPES[key])
    pad = np.full((max_periods - len(x), *x.shape[1:]), key == "all_done",
                  x.dtype)
    return np.concatenate([x, pad])


# ---------------------------------------------------------------------------
# Fleet engine: a sweep over many seeds, a chunk at a time.
# ---------------------------------------------------------------------------

def fleet_geometry(seeds, mesh, chunk_size: int | None):
    """Normalize a fleet request: derive the chunk grid (the reference's
    arithmetic on one device) and pad the seed list with repeats of its
    last seed to whole chunks.  Returns ``(mesh, axis, n_dev, chunk,
    n_chunks, padded_seeds)``, as the reference does.  One card is one
    device: ``mesh`` must be None (sharding a fleet over several cards
    waits for the port's distributed layer)."""
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("fleet sweeps need at least one seed")
    if mesh is not None:
        raise NotImplementedError(
            "a fleet mesh over several devices needs the port's distributed "
            "layer (ROADMAP Queue A item 12); pass mesh=None")
    chunk = max(1, min(chunk_size or FLEET_CHUNK, len(seeds)))
    n_chunks = -(-len(seeds) // chunk)
    padded = seeds + [seeds[-1]] * (n_chunks * chunk - len(seeds))
    return None, FLEET_AXIS, 1, chunk, n_chunks, padded


def fleet_chunks(seeds: list, chunk: int) -> list[list[int]]:
    """The fleet's real seeds, chunk by chunk (the pad seeds would be
    dropped before summarizing, so no chunk runs them)."""
    return [seeds[i:i + chunk] for i in range(0, len(seeds), chunk)]


def _concat(parts: list):
    """Chunk results (numpy arrays, lists, or dicts of them) joined along
    the seed axis."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, list):
        return [x for p in parts for x in p]
    return np.concatenate(parts)


def run_fleet(cfg: SimConfig, seeds, net: network.NetworkConfig | None = None,
              *, mesh=None, chunk_size: int | None = None,
              device=None) -> dict:
    """A Monte-Carlo sweep over ``seeds``, ``chunk_size`` episodes at a
    time (default ``FLEET_CHUNK``).  Each chunk runs as ``run_batch`` runs
    it and its outputs reach host numpy before the next chunk starts;
    without ``collect_history`` no (S, T) array is built.  Per seed the
    outputs are bitwise ``run_batch``'s, at every chunk size.  Returns the
    ``run_batch`` summary plus a ``"fleet"`` record of the geometry."""
    device = torch.device(device) if device is not None else default_device()
    net = net or _default_net(cfg)
    seeds = [int(s) for s in seeds]
    _, axis, n_dev, chunk, n_chunks, padded = fleet_geometry(
        seeds, mesh, chunk_size)
    parts = [run_batch(cfg, part, net, device=device)
             for part in fleet_chunks(seeds, chunk)]
    out = _concat(parts)
    out["fleet"] = {"n_devices": n_dev, "mesh_axis": axis, "chunk": chunk,
                    "n_chunks": n_chunks, "padded_to": len(padded)}
    return out


# ---------------------------------------------------------------------------
# Legacy checkpointable engine.
# ---------------------------------------------------------------------------

def _state_to_json(state) -> list:
    """A scenario or policy state's leaves as nested lists (float32 values
    print as the float64 that holds them, so they read back bit for
    bit)."""
    return [leaf.detach().cpu().tolist() for leaf in tree.leaves(state)]


def _state_from_json(template, data: list):
    """The state of ``_state_to_json`` rebuilt in ``template``'s structure,
    dtypes, shapes and device."""
    leaves = tree.leaves(template)
    if len(data) != len(leaves):
        raise ValueError(
            f"checkpointed scenario state has {len(data)} leaves, the "
            f"configured processes expect {len(leaves)} -- was the "
            f"checkpoint written under a different scenario?")
    return tree.unflatten(template, [
        torch.tensor(d, dtype=leaf.dtype).reshape(leaf.shape).to(leaf.device)
        for d, leaf in zip(data, leaves)])


def run(cfg: SimConfig, net: network.NetworkConfig | None = None,
        state: dict | None = None, checkpoint_path: str | None = None,
        device=None) -> dict:
    """Per-period loop until every service finishes.

    Runs the same period step as ``run_scan`` on the same draws (so the
    durations match it exactly) but keeps plain-dict state: ``state``
    resumes a previous partial run and ``checkpoint_path`` gets a JSON
    snapshot after every period, written to ``<path>.tmp`` and renamed
    into place.  A period with no active service is skipped when every
    process is stateless (each period draws from its own generator, so
    no later draw shifts).  A snapshot written under another
    ``DRAW_STREAM`` is refused.
    """
    device = torch.device(device) if device is not None else default_device()
    net = net or _default_net(cfg)
    arrivals, counts = _static_draws(cfg, net)
    n, k_max = cfg.n_services_total, _k_cap(cfg)
    if state is None:
        state = {"period": 0, "rounds_done": [0] * n, "duration": [0] * n,
                 "history": [], "draw_stream": DRAW_STREAM}
    elif state["period"] > 0 and state.get("draw_stream") != DRAW_STREAM:
        raise ValueError(
            f"resume state was written under draw stream "
            f"{state.get('draw_stream')!r}, this engine draws "
            f"{DRAW_STREAM!r} -- the checkpoint's arrivals cannot be "
            f"reconstructed; restart the episode")
    period = state["period"]
    rounds_done = list(state["rounds_done"])
    duration = list(state["duration"])
    history = list(state["history"])

    pol = policy_mod.get_stateful_policy(
        cfg.policy, warm_start=cfg.warm_start, n_bids=cfg.n_bids,
        alpha_fair=cfg.alpha_fair, intra_backend=cfg.intra_backend)
    chan = scenarios.get_channel(cfg.channel_process, net)
    churn = scenarios.get_churn(cfg.churn_process, net)
    sampler = default_sampler(cfg, net, counts, device)
    init = GeneratorSource(device, cfg.seed + 7)

    def restored(name: str, template):
        if name in state:
            return _state_from_json(template, state[name])
        if period > 0 and tree.leaves(template):
            raise ValueError(
                f"resume state has no {name!r} but the configured scenario/"
                f"policy processes are stateful -- was the snapshot written "
                f"under a different configuration?")
        return template

    chan_state = restored("chan_state", chan.init(init, n, k_max))
    churn_state = restored("churn_state", churn.init(init, n, k_max))
    pol_state = restored("pol_state", pol.init_state(n, device))
    stateless = not tree.leaves((chan_state, churn_state, pol_state))
    arrivals_t = torch.as_tensor(arrivals, dtype=torch.int32, device=device)

    def snapshot() -> dict:
        return {"period": period, "rounds_done": rounds_done,
                "duration": duration, "history": history,
                "draw_stream": DRAW_STREAM,
                "chan_state": _state_to_json(chan_state),
                "churn_state": _state_to_json(churn_state),
                "pol_state": _state_to_json(pol_state)}

    while period < cfg.max_periods:
        if all(r >= cfg.rounds_required for r in rounds_done):
            break
        active = [i for i in range(n) if arrivals[i] <= period
                  and rounds_done[i] < cfg.rounds_required]
        if active or not stateless:
            (rd, du, chan_state, churn_state, pol_state, stats,
             _) = _period_step(
                torch.tensor(rounds_done, dtype=torch.int32, device=device),
                torch.tensor(duration, dtype=torch.int32, device=device),
                chan_state, churn_state, pol_state, period, arrivals_t,
                sampler(period), policy_fn=pol.step, chan_step=chan.step,
                churn_step=churn.step, chan_rebuilds=chan.rebuilds, net=net,
                rounds_required=cfg.rounds_required)
            rounds_done, duration = rd.tolist(), du.tolist()
            if active:
                history.append({"period": period, "active": active,
                                "freq_sum": float(stats["freq_sum"]),
                                "objective": float(stats["objective"]),
                                "n_clients": int(stats["n_clients"])})
        period += 1
        if checkpoint_path is not None:
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "w") as fp:
                json.dump(snapshot(), fp)
            os.replace(tmp, checkpoint_path)

    out = {"avg_duration": float(np.mean(duration)),
           "std_duration": float(np.std(duration)),
           "durations": duration, "periods": period, "history": history,
           "finished": all(r >= cfg.rounds_required for r in rounds_done),
           "state": snapshot()}
    if not cfg.collect_history:
        # run_scan's aggregate-mode keys; the snapshot keeps the full list
        out["history"] = None
        out["totals"] = {
            "freq_sum": float(sum(h["freq_sum"] for h in history)),
            "objective": float(sum(h["objective"] for h in history)),
            "n_active": float(sum(len(h["active"]) for h in history)),
            "n_clients": float(sum(h["n_clients"] for h in history))}
    return out
