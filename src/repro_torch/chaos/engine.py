"""The chaos engine: drive an AllocDaemon through a seeded fault storm.

``run_storm`` is the one-call entry point: it builds a daemon (optionally
checkpointing into ``checkpoint_dir``), runs ``n_periods`` wall-clock
periods with the given injectors firing from a ``ChaosSchedule``, and
returns a JSON-able report: trajectory, degradation metrics, recovery
statistics, invariant results, and a sha256 digest over the trajectory
plus every served allocation.  Two storms with the same ``(config,
seed)`` on one device produce the same digest; a divergence means
nondeterminism leaked into a degradation path.

Wall-clock periods vs plane periods: the engine counts every serve (the
loop index ``t``), while ``plane.period`` advances only on fresh solves;
the gap between the two is the storm's stale/degraded serves plus any
work lost to restarts (``decisions_lost`` in the report).
"""
from __future__ import annotations

import asyncio
import hashlib
import json
from typing import Callable

import numpy as np

from repro_torch.chaos import invariants as invariants_mod
from repro_torch.chaos.injectors import (AdmissionChaos, CheckpointChaos,
                                         HeartbeatChaos, Injector,
                                         SolverChaos)
from repro_torch.chaos.schedule import ChaosSchedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import network
from repro_torch.fl.control_plane import ControlPlaneConfig
from repro_torch.launch import allocd


def default_injectors(k_max: int, *,
                      with_checkpoint: bool = True) -> list[Injector]:
    """The full catalogue at default rates.  AdmissionChaos doubles as the
    storm's workload generator, so it is always included."""
    out: list[Injector] = [HeartbeatChaos(), SolverChaos()]
    if with_checkpoint:
        out.append(CheckpointChaos())
    out.append(AdmissionChaos(k_max))
    return out


class ChaosEngine:
    """Run one storm: per wall-clock period, fire every injector's ``pre``
    hook, deliver healthy heartbeats for non-suppressed services, serve one
    decision, then fire ``post`` hooks (which may kill and restart the
    daemon)."""

    def __init__(self, factory: Callable[[], allocd.AllocDaemon],
                 injectors: list[Injector], seed: int):
        self.factory = factory
        self.injectors = injectors
        self.schedule = ChaosSchedule(seed)
        self.daemon = factory()
        self.trajectory: list[dict] = []
        self.served: list = []
        # Per wall-clock period: sorted slots occupied just before the
        # serve, for the retired-slots-never-allocated invariant.
        self.occupancy: list[list[int]] = []
        self.restarts = 0
        self.suppress_hb: set = set()

    def restart_daemon(self) -> None:
        """Crash semantics: the old daemon is abandoned without ``close``
        (no final checkpoint, queued requests lost) and the replacement
        auto-restores from the newest checkpoint that still verifies."""
        self.restarts += 1
        self.daemon = self.factory()

    async def run_async(self, n_periods: int) -> None:
        try:
            for t in range(n_periods):
                self.suppress_hb.clear()
                events: list[dict] = []
                for inj in self.injectors:
                    for ev in inj.pre(self, t):
                        events.append({"period": t, "injector": inj.name,
                                       **ev})
                plane = self.daemon.plane
                if plane.cfg.heartbeat_timeout_periods is not None:
                    for sid in list(plane.services):
                        if sid not in self.suppress_hb:
                            self.daemon.submit(allocd.Heartbeat(sid))
                pre_occ = {r.slot for r in plane.services.values()}
                n_retired = len(plane.retired)
                decision = await self.daemon.step_period()
                self.served.append(decision)
                # Slots legitimately allocatable this period: occupied before
                # the serve, admitted by requests drained inside it (active
                # from the very tick that drains them), or retired during it
                # (a service can be admitted, cleared, and complete within
                # one tick: it was occupied while the allocation ran).
                post_occ = {r.slot for r in plane.services.values()}
                mid_occ = {r.slot for r in plane.retired[n_retired:]}
                self.occupancy.append(sorted(pre_occ | post_occ | mid_occ))
                for inj in self.injectors:
                    for ev in inj.post(self, t, decision):
                        events.append({"period": t, "injector": inj.name,
                                       **ev})
                self.trajectory.extend(events)
        finally:
            await self.daemon.close()

    def run(self, n_periods: int) -> None:
        asyncio.run(self.run_async(n_periods))

    def digest(self) -> str:
        """sha256 over the event trajectory and every served allocation:
        the storm's replayability fingerprint."""
        h = hashlib.sha256()
        h.update(json.dumps(self.trajectory, sort_keys=True).encode())
        for d in self.served:
            h.update(f"{d.period}|{int(d.stale)}|{int(d.degraded)}|".encode())
            h.update(np.asarray(d.b, np.float32).tobytes())
            h.update(np.asarray(d.f, np.float32).tobytes())
            h.update(np.asarray(d.active, bool).tobytes())
        return h.hexdigest()


def _recovery_runs(served) -> list[int]:
    """Lengths of maximal consecutive non-fresh (stale or degraded) runs:
    each is one outage's recovery time in periods."""
    runs, cur = [], 0
    for d in served:
        if d.stale or d.degraded:
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    if cur:
        runs.append(cur)
    return runs


def run_storm(cfg: ControlPlaneConfig, *, seed: int, n_periods: int,
              injectors: list[Injector] | None = None,
              net: network.NetworkConfig | None = None,
              checkpoint_dir: str | None = None, save_every: int = 5,
              max_stale_streak: int = 4, admit_max_retries: int = 3,
              check_invariants: bool = True, device=None,
              sampler: Callable | None = None) -> dict:
    """Run one seeded storm on ``device`` (default: the card) and report.
    Same ``(cfg, seed, n_periods, injectors)`` on one device -> identical
    ``digest``.  ``sampler`` replaces the period draws as in ``run_scan``."""

    def factory() -> allocd.AllocDaemon:
        manager = (CheckpointManager(checkpoint_dir)
                   if checkpoint_dir else None)
        return allocd.AllocDaemon(
            cfg, net, manager=manager, save_every=save_every,
            max_stale_streak=max_stale_streak,
            admit_max_retries=admit_max_retries, device=device,
            sampler=sampler)

    if injectors is None:
        injectors = default_injectors(
            cfg.k_max, with_checkpoint=checkpoint_dir is not None)
    engine = ChaosEngine(factory, injectors, seed)
    engine.run(n_periods)

    plane = engine.daemon.plane
    served = engine.served
    n_fresh = sum(1 for d in served if not d.stale)
    n_stale = sum(1 for d in served if d.stale and not d.degraded)
    n_degraded = sum(1 for d in served if d.degraded)
    runs = _recovery_runs(served)
    report = {
        "seed": int(seed),
        "n_periods": int(n_periods),
        "restarts": int(engine.restarts),
        "events": engine.trajectory,
        "n_events": len(engine.trajectory),
        "metrics": {k: int(v) for k, v in plane.metrics.items()},
        "rejections": len(engine.daemon.rejections),
        "served": {"fresh": n_fresh, "stale": n_stale,
                   "degraded": n_degraded},
        # Fresh serves the surviving daemon no longer remembers: work
        # replayed (and thus lost) because a restart restored an older
        # checkpoint.  0 when no restart fired.
        "decisions_lost": max(0, n_fresh - plane.period),
        "recovery": {
            "outages": len(runs),
            "max_periods": max(runs) if runs else 0,
            "mean_periods": float(np.mean(runs)) if runs else 0.0,
        },
        "digest": engine.digest(),
    }
    if check_invariants:
        report["invariants"] = invariants_mod.verify(
            served, plane, occupancy=engine.occupancy)
    return report
