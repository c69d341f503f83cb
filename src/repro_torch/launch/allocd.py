"""allocd: asyncio bandwidth-allocation daemon over the market step.

The serving front end of ``fl.control_plane``: an event loop that

* drains an **asyncio request queue** (admit / retire / heartbeat) in
  batches between period ticks, so a burst of arrivals lands as one set of
  mask flips before the next clear;
* runs each period's solve **off the event loop** (an executor thread,
  which launches the allocation kernels on the device's default stream)
  and **degrades gracefully** when it misses its deadline: past
  ``solver_timeout_s`` the daemon serves the previous period's allocation
  rescaled to the live admission mask, counted in the ``stale_decisions``
  metric, and the in-flight solve still commits its carry before the next
  period launches.  Only a timeout becomes a stale decision: an error
  raised by the solve (a kernel's launch error among them) propagates;
* **checkpoints** the serving state through ``CheckpointManager``'s COMMIT
  protocol every ``save_every`` cleared periods and auto-restores the
  newest complete snapshot at startup.

Requests that arrive while a solve is in flight stay queued and apply at
the next idle drain: the state the solver reads is never mutated
concurrently, and one daemon's solves never overlap.

Degradation paths are bounded and counted (never silent): capacity-full
admissions retry with exponential period backoff before landing in
``rejections``; a stale streak longer than ``max_stale_streak`` degrades
to the O(1) equal-share decision; non-finite solver outputs are caught by
the plane.  ``repro_torch.chaos`` exercises all of them under seeded fault
injection.

Usage (synthetic Poisson workload, prints a serving summary and, with
``--check``, the differential replay against ``simulator.run_scan``):

  PYTHONPATH=src python -m repro_torch.launch.allocd --capacity 16 \\
      --periods 40 --rate 0.5 --policy coop [--cold] [--check] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import network
from repro_torch.fl.control_plane import (ControlPlane, ControlPlaneConfig,
                                          Decision)


@dataclasses.dataclass(frozen=True)
class Admit:
    service_id: Any
    n_clients: int


@dataclasses.dataclass(frozen=True)
class Retire:
    service_id: Any


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    service_id: Any
    client: int | None = None


class AllocDaemon:
    """Event-loop wrapper around one ``ControlPlane``.

    ``submit`` enqueues requests from any coroutine; ``step_period`` serves
    exactly one decision (fresh or stale); ``serve`` runs the loop.  The
    ``served`` list is the wall-clock stream (may contain stale entries);
    ``plane.decisions`` is the fresh-solve stream the differential replay
    checks.  ``device`` and ``sampler`` go to the plane.
    """

    def __init__(self, cfg: ControlPlaneConfig,
                 net: network.NetworkConfig | None = None, *,
                 solver_timeout_s: float | None = None,
                 manager: CheckpointManager | None = None,
                 save_every: int = 10,
                 max_stale_streak: int = 8,
                 admit_max_retries: int = 3,
                 device=None, sampler: Callable | None = None):
        self.plane = ControlPlane(cfg, net, device=device, sampler=sampler)
        self.solver_timeout_s = solver_timeout_s
        self.manager = manager
        self.save_every = max(int(save_every), 1)
        self.max_stale_streak = max(int(max_stale_streak), 1)
        self.admit_max_retries = max(int(admit_max_retries), 0)
        self.requests: asyncio.Queue = asyncio.Queue()
        self.served: list[Decision] = []
        self.rejections: list[tuple[Any, str]] = []
        # Capacity-rejected admits awaiting retry: (request, attempts,
        # not-before period), exponential backoff in periods.
        self._retry_queue: list[tuple[Admit, int, int]] = []
        self.stale_streak = 0
        self.resumed = bool(manager and self.plane.restore(manager))
        self._pending: asyncio.Future | None = None
        # Test hook: extra seconds of solver latency injected inside the
        # executor call, to exercise the timeout -> stale path.
        self._solver_delay_s = 0.0
        # Chaos hook: force the next step_period to skip the solve and
        # serve stale, a *deterministic* deadline miss (wall-clock timeouts
        # are not replayable; repro_torch.chaos drives this).
        self._force_stale_next = False

    def submit(self, request) -> None:
        self.requests.put_nowait(request)

    def _try_admit(self, req: Admit, attempts: int) -> None:
        """Admit with bounded retry: a capacity rejection (transient: a
        slot may free up) re-queues the request with exponential period
        backoff (1, 2, 4, ... periods, ``admit_max_retries`` attempts);
        validation errors (duplicate id, bad n_clients) are permanent and
        land in ``rejections`` at once."""
        try:
            self.plane.admit(req.service_id, req.n_clients)
        except RuntimeError as exc:
            if attempts < self.admit_max_retries:
                self.plane.metrics["admit_retries"] += 1
                self._retry_queue.append(
                    (req, attempts + 1, self.plane.period + 2 ** attempts))
            else:
                self.rejections.append(
                    (req.service_id,
                     f"RuntimeError: {exc} (gave up after {attempts} "
                     f"retries)"))
        except (ValueError, KeyError) as exc:
            self.rejections.append((req.service_id,
                                    f"{type(exc).__name__}: {exc}"))

    def _drain(self) -> None:
        """Apply every queued request; called only while no solve is in
        flight, so the step never races a registry mutation."""
        period = self.plane.period
        due = [r for r in self._retry_queue if r[2] <= period]
        self._retry_queue = [r for r in self._retry_queue if r[2] > period]
        for req, attempts, _ in due:
            self._try_admit(req, attempts)
        while True:
            try:
                req = self.requests.get_nowait()
            except asyncio.QueueEmpty:
                return
            try:
                if isinstance(req, Admit):
                    self._try_admit(req, 0)
                elif isinstance(req, Retire):
                    self.plane.retire(req.service_id)
                elif isinstance(req, Heartbeat):
                    self.plane.heartbeat(req.service_id, req.client)
                else:
                    raise TypeError(f"unknown request {req!r}")
            except (RuntimeError, ValueError, KeyError) as exc:
                self.rejections.append((getattr(req, "service_id", None),
                                        f"{type(exc).__name__}: {exc}"))

    def _tick_blocking(self) -> Decision:
        if self._solver_delay_s:
            time.sleep(self._solver_delay_s)
        return self.plane.tick()

    async def step_period(self) -> Decision:
        """Serve one decision.  Launches a solve when idle; if the pending
        solve outruns ``solver_timeout_s`` (or a chaos-injected deadline
        miss fires), serves a stale decision instead and leaves the solve to
        commit in the background.  After ``max_stale_streak`` consecutive
        non-fresh periods the daemon stops rescaling an ever-older clear
        and degrades to the O(1) equal-share decision (counted in
        ``degraded_decisions``, flagged apart)."""
        decision = None
        if self._force_stale_next:
            # Deterministic deadline miss: the solve is not even launched
            # this period, so no background commit races the stale serve.
            self._force_stale_next = False
        else:
            if self._pending is None:
                self._drain()
                loop = asyncio.get_running_loop()
                self._pending = loop.run_in_executor(
                    None, self._tick_blocking)
            try:
                decision = await asyncio.wait_for(
                    asyncio.shield(self._pending), self.solver_timeout_s)
                self._pending = None
                self.stale_streak = 0
                if self.manager and self.plane.period % self.save_every == 0:
                    self.plane.snapshot(self.manager)
            except asyncio.TimeoutError:
                pass
        if decision is None:
            self.stale_streak += 1
            if self.stale_streak >= self.max_stale_streak:
                decision = self.plane.degraded_decision()
            else:
                decision = self.plane.stale_decision()
        self.served.append(decision)
        return decision

    async def close(self) -> None:
        """Let any in-flight solve commit, then take a final checkpoint."""
        if self._pending is not None:
            await self._pending
            self._pending = None
        if self.manager:
            self.plane.snapshot(self.manager)

    async def serve(self, n_periods: int,
                    period_interval_s: float = 0.0) -> list[Decision]:
        for _ in range(n_periods):
            await self.step_period()
            if period_interval_s:
                await asyncio.sleep(period_interval_s)
        await self.close()
        return self.served


def poisson_admissions(rng: np.random.Generator, rate: float, n_periods: int,
                       k_max: int) -> dict[int, list[Admit]]:
    """Synthetic workload: per-period Poisson(rate) admissions with uniform
    cohort sizes, ids ``svc-<period>-<i>``."""
    out: dict[int, list[Admit]] = {}
    for p in range(n_periods):
        n_new = int(rng.poisson(rate))
        if n_new:
            out[p] = [
                Admit(f"svc-{p}-{i}", int(rng.integers(2, k_max + 1)))
                for i in range(n_new)
            ]
    return out


async def run_workload(daemon: AllocDaemon,
                       workload: dict[int, list[Admit]],
                       n_periods: int) -> list[Decision]:
    """Submit each period's requests, then serve the period; close."""
    for p in range(n_periods):
        for req in workload.get(p, ()):
            daemon.submit(req)
        await daemon.step_period()
    await daemon.close()
    return daemon.served


def replay_check(plane: ControlPlane) -> tuple[int, bool]:
    """(periods compared, whether the plane's fresh b, f and activity equal
    ``run_scan``'s replay of its trace bitwise)."""
    hist = plane.replay_reference()["history"]
    n = min(len(plane.decisions), len(hist["b"]))
    exact = all(
        np.array_equal(np.stack([getattr(d, key) for d in
                                 plane.decisions[:n]]), hist[key][:n])
        for key in ("b", "f", "active"))
    return n, exact


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--capacity", type=int, default=16)
    ap.add_argument("--periods", type=int, default=40)
    ap.add_argument("--policy", default="coop")
    ap.add_argument("--k-max", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=200,
                    help="rounds each service needs before departing")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean admissions per period (Poisson)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cold", action="store_true",
                    help="disable warm-started duals (cold solve each period)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="solver deadline in seconds (stale fallback past it)")
    ap.add_argument("--heartbeat-timeout", type=int, default=None,
                    help="periods without a heartbeat before a client drops")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--check", action="store_true",
                    help="differential replay vs simulator.run_scan")
    ap.add_argument("--device", default="cuda",
                    help="torch device the daemon runs on (default: cuda)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the summary it prints (served, rate, metrics,
    and with ``--check`` the replay's verdict)."""
    args = build_parser().parse_args(argv)
    cfg = ControlPlaneConfig(
        capacity=args.capacity, k_max=args.k_max, policy=args.policy,
        warm_start=not args.cold, rounds_required=args.rounds,
        seed=args.seed, heartbeat_timeout_periods=args.heartbeat_timeout,
    )
    manager = (CheckpointManager(args.checkpoint_dir)
               if args.checkpoint_dir else None)
    daemon = AllocDaemon(cfg, solver_timeout_s=args.timeout, manager=manager,
                         save_every=args.save_every, device=args.device)
    if daemon.resumed:
        print(f"[allocd] resumed at period {daemon.plane.period}")
    workload = poisson_admissions(np.random.default_rng(args.seed),
                                  args.rate, args.periods, args.k_max)
    t0 = time.perf_counter()
    served = asyncio.run(run_workload(daemon, workload, args.periods))
    dt = time.perf_counter() - t0
    m = daemon.plane.metrics
    summary = {"served": len(served),
               "decisions_per_s": len(served) / max(dt, 1e-9),
               "metrics": dict(m), "rejections": len(daemon.rejections)}
    print(f"[allocd] served {len(served)} decisions in {dt:.2f}s "
          f"({summary['decisions_per_s']:.1f}/s) on {daemon.plane.device}")
    print(f"[allocd] admitted={m['admitted']} retired={m['retired']} "
          f"rejected={m['rejected'] + len(daemon.rejections)} "
          f"stale_decisions={m['stale_decisions']} "
          f"heartbeat_drops={m['heartbeat_drops']}")
    # Degradation counters: all zero on a healthy run, none ever silent.
    print(f"[allocd] solver_fallbacks={m['solver_fallbacks']} "
          f"degraded_decisions={m['degraded_decisions']} "
          f"nonfinite_decisions={m['nonfinite_decisions']} "
          f"carry_repairs={m['carry_repairs']} "
          f"checkpoint_skips={m['checkpoint_skips']} "
          f"admit_retries={m['admit_retries']}")
    if args.check:
        if not daemon.plane.replayable:
            reasons = (daemon.plane.unreplayable_reasons
                       or ["slot reuse / forced retire"])
            print(f"[allocd] trace not replayable ({reasons})")
            summary["replay"] = None
            return summary
        n, exact = replay_check(daemon.plane)
        summary["replay"] = {"periods": n, "bitwise": exact}
        print(f"[allocd] replay check over {n} periods: "
              f"{'bitwise equal' if exact else 'MISMATCH'}")
    return summary


if __name__ == "__main__":
    main()
