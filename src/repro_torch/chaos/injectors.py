"""Fault injectors over a live AllocDaemon.

Each injector exposes ``pre(engine, period)`` (before the period's serve)
and ``post(engine, period, decision)`` (after it), returning a list of
JSON-able event dicts that the engine appends to the storm trajectory.
All randomness comes from ``engine.schedule.rng(period, channel)`` with an
injector-owned channel name, so storms replay bitwise from the seed and
injectors never perturb each other's draws.  The draws, and so the events,
are the JAX package's event for event.

Injectors hold per-storm mutable state (e.g. flap down-counters): build a
fresh instance per storm (``engine.default_injectors`` does).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import policy as policy_mod
from repro_torch.launch import allocd


class Injector:
    """Base injector: no-op hooks plus the trajectory-channel name."""

    name = "injector"

    def pre(self, engine, period: int) -> list[dict]:
        return []

    def post(self, engine, period: int, decision) -> list[dict]:
        return []


# ---------------------------------------------------------------------------
# Poison helpers (used by SolverChaos and unit tests directly).
# ---------------------------------------------------------------------------

def poison_channel_state(plane, rng: np.random.Generator) -> dict | None:
    """Write one NaN/Inf into a float leaf of the plane's channel-state
    carry (the fault the warm solver's sanitize and the plane's carry
    repair must absorb), on the carry's device.  The leaves are listed in
    the JAX package's flatten order (the fields of each NamedTuple, in
    order), so the pick equals its pick.  Returns an event dict, or None
    when the channel process carries no float state (e.g. ``iid``)."""
    carry = list(plane._carry)
    leaves = tree.leaves(carry[2])
    float_idx = [i for i, leaf in enumerate(leaves)
                 if leaf.is_floating_point() and leaf.numel() > 0]
    if not float_idx:
        return None
    i = float_idx[int(rng.integers(len(float_idx)))]
    leaf = leaves[i].clone()
    j = int(rng.integers(leaf.numel()))
    value = float(rng.choice([np.nan, np.inf, -np.inf]))
    leaf.view(-1)[j] = value
    leaves[i] = leaf
    carry[2] = tree.unflatten(carry[2], leaves)
    plane._carry = tuple(carry)
    return {"action": "poison_channel", "leaf": int(i), "index": int(j),
            "value": repr(value)}


def poison_warm_seed(plane, rng: np.random.Generator,
                     value: float | None = None) -> dict | None:
    """Corrupt the warm dual seed: NaN/Inf (must trigger the counted
    cold-bisection fallback) or a badly-stale finite price (the safeguarded
    bracket must absorb it).  None when the policy carries no warm state."""
    pol_state = plane._carry[4]
    if not isinstance(pol_state, policy_mod.WarmDualState):
        return None
    if value is None:
        value = float(rng.choice([np.nan, np.inf, 1e7]))
    carry = list(plane._carry)
    carry[4] = pol_state._replace(lam=torch.tensor(
        value, dtype=torch.float32, device=pol_state.lam.device))
    plane._carry = tuple(carry)
    return {"action": "poison_warm_seed", "value": repr(float(value))}


# ---------------------------------------------------------------------------
# The injector families.
# ---------------------------------------------------------------------------

class HeartbeatChaos(Injector):
    """Heartbeat faults: drop / delay / duplicate / flap.

    The engine sends a healthy heartbeat for every registered service each
    period unless the service id is in ``engine.suppress_hb``; this injector
    fills that set.  A flap takes a service down for ``1 + Geometric``
    whole periods; a drop/delay silences exactly one period (a delayed
    heartbeat is indistinguishable from dropping it for the period it
    missed); duplicates submit extra Heartbeat requests (idempotence).
    """

    name = "heartbeat"

    def __init__(self, p_drop: float = 0.08, p_delay: float = 0.05,
                 p_dup: float = 0.05, p_flap: float = 0.03,
                 flap_mean: float = 2.0):
        self.p_drop = p_drop
        self.p_delay = p_delay
        self.p_dup = p_dup
        self.p_flap = p_flap
        self.flap_mean = max(float(flap_mean), 1.0)
        self._down: dict[Any, int] = {}

    def pre(self, engine, period: int) -> list[dict]:
        events = []
        plane = engine.daemon.plane
        for sid in list(plane.services):
            rng = engine.schedule.rng(period, f"hb/{sid}")
            down = self._down.get(sid, 0)
            if down > 0:
                self._down[sid] = down - 1
                engine.suppress_hb.add(sid)
                events.append({"action": "flap_down", "service": str(sid)})
                continue
            u = rng.random(4)
            if u[0] < self.p_flap:
                n = int(1 + rng.geometric(1.0 / self.flap_mean))
                self._down[sid] = n - 1
                engine.suppress_hb.add(sid)
                events.append({"action": "flap_start", "service": str(sid),
                               "periods": n})
            elif u[1] < self.p_drop:
                engine.suppress_hb.add(sid)
                events.append({"action": "drop", "service": str(sid)})
            elif u[2] < self.p_delay:
                engine.suppress_hb.add(sid)
                events.append({"action": "delay", "service": str(sid)})
            elif u[3] < self.p_dup:
                engine.daemon.submit(allocd.Heartbeat(sid))
                engine.daemon.submit(allocd.Heartbeat(sid))
                events.append({"action": "duplicate", "service": str(sid)})
        return events


class SolverChaos(Injector):
    """Solver faults: deterministic deadline misses (forced stale serve),
    NaN/Inf-poisoned channel state, corrupted warm dual seeds."""

    name = "solver"

    def __init__(self, p_deadline: float = 0.1, p_poison_chan: float = 0.05,
                 p_poison_seed: float = 0.04):
        self.p_deadline = p_deadline
        self.p_poison_chan = p_poison_chan
        self.p_poison_seed = p_poison_seed

    def pre(self, engine, period: int) -> list[dict]:
        events = []
        rng = engine.schedule.rng(period, "solver")
        u = rng.random(3)
        if u[0] < self.p_deadline:
            engine.daemon._force_stale_next = True
            events.append({"action": "deadline_miss"})
        if u[1] < self.p_poison_chan:
            ev = poison_channel_state(engine.daemon.plane, rng)
            if ev:
                events.append(ev)
        if u[2] < self.p_poison_seed:
            ev = poison_warm_seed(engine.daemon.plane, rng)
            if ev:
                events.append(ev)
        return events


class CheckpointChaos(Injector):
    """Checkpoint faults against the daemon's manager directory: torn writes
    (COMMIT removed), corrupted npz payloads and truncated shards *behind an
    intact COMMIT* (checksum verification must catch them), and restart
    storms (the engine rebuilds the daemon, which auto-restores from the
    newest checkpoint that still verifies)."""

    name = "checkpoint"

    def __init__(self, p_torn: float = 0.04, p_truncate: float = 0.04,
                 p_corrupt: float = 0.04, p_restart: float = 0.06):
        self.p_torn = p_torn
        self.p_truncate = p_truncate
        self.p_corrupt = p_corrupt
        self.p_restart = p_restart

    @staticmethod
    def _newest_shard(mgr, step: int) -> str:
        return os.path.join(mgr._step_dir(step), "shard_0000.npz")

    def post(self, engine, period: int, decision) -> list[dict]:
        mgr = engine.daemon.manager
        if mgr is None:
            return []
        events = []
        rng = engine.schedule.rng(period, "checkpoint")
        u = rng.random(4)
        steps = mgr.all_steps()
        if steps and u[0] < self.p_torn:
            step = steps[-1]
            commit = os.path.join(mgr._step_dir(step), "COMMIT")
            if os.path.exists(commit):
                os.remove(commit)
                events.append({"action": "torn_commit", "step": int(step)})
        steps = mgr.all_steps()
        if steps and u[1] < self.p_truncate:
            step = steps[-1]
            shard = self._newest_shard(mgr, step)
            if os.path.exists(shard):
                size = os.path.getsize(shard)
                with open(shard, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                events.append({"action": "truncate_shard", "step": int(step)})
        steps = mgr.all_steps()
        if steps and u[2] < self.p_corrupt:
            step = steps[-1]
            shard = self._newest_shard(mgr, step)
            if os.path.exists(shard):
                size = os.path.getsize(shard)
                with open(shard, "r+b") as f:
                    f.seek(size // 2)
                    byte = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
                events.append({"action": "corrupt_shard", "step": int(step)})
        if u[3] < self.p_restart:
            engine.restart_daemon()
            events.append({
                "action": "restart",
                "restored_period": int(engine.daemon.plane.period),
                "skipped": [int(s) for s, _ in
                            getattr(engine.daemon.manager, "last_skipped",
                                    [])],
            })
        return events


class AdmissionChaos(Injector):
    """Admission faults AND the storm's base workload: a steady trickle of
    admissions, bursts that overshoot capacity (exercising the daemon's
    bounded retry), duplicate admits of a live id, retires of unknown ids.
    Every malformed request must land as a recorded rejection: never a
    crash, never a silent drop."""

    name = "admission"

    def __init__(self, k_max: int, p_admit: float = 0.35,
                 p_burst: float = 0.08, burst_max: int = 4,
                 p_dup: float = 0.06, p_retire_unknown: float = 0.05):
        self.k_max = int(k_max)
        self.p_admit = p_admit
        self.p_burst = p_burst
        self.burst_max = max(int(burst_max), 2)
        self.p_dup = p_dup
        self.p_retire_unknown = p_retire_unknown

    def _admit(self, engine, period: int, i: int,
               rng: np.random.Generator) -> dict:
        sid = f"svc-{period}-{i}"
        k = int(rng.integers(2, self.k_max + 1))
        engine.daemon.submit(allocd.Admit(sid, k))
        return {"action": "admit", "service": sid, "n_clients": k}

    def pre(self, engine, period: int) -> list[dict]:
        events = []
        rng = engine.schedule.rng(period, "admission")
        u = rng.random(4)
        if u[0] < self.p_admit:
            events.append(self._admit(engine, period, 0, rng))
        if u[1] < self.p_burst:
            n = int(rng.integers(2, self.burst_max + 1))
            for i in range(1, n + 1):
                events.append(self._admit(engine, period, i, rng))
            events.append({"action": "burst", "n": n})
        plane = engine.daemon.plane
        if u[2] < self.p_dup and plane.services:
            sids = list(plane.services)
            sid = sids[int(rng.integers(len(sids)))]
            engine.daemon.submit(
                allocd.Admit(sid, int(rng.integers(2, self.k_max + 1))))
            events.append({"action": "duplicate_admit", "service": str(sid)})
        if u[3] < self.p_retire_unknown:
            engine.daemon.submit(allocd.Retire(f"ghost-{period}"))
            events.append({"action": "retire_unknown",
                           "service": f"ghost-{period}"})
        return events
