"""Live allocation control plane: online service admission over the
warm-started market-clearing step.

The offline engines (``fl.simulator``) evaluate a recorded episode; this
module is the serving side of the same period step: FL services arrive
and depart while the network provider keeps clearing the market (paper
§III/§V), so the allocator runs as a long-lived daemon that

* **admits / retires services online** into free slots of one
  fixed-capacity mask-padded ServiceSet: an admission is a mask flip plus
  two array writes, never a shape change;
* **holds warm policy state** (the ``StatefulPolicy`` carry, e.g. warm
  ``coop``'s dual price) across requests;
* **drives per-client churn from heartbeats**: a client whose last
  heartbeat is older than ``heartbeat_timeout_periods`` is dropped from
  the next period's clear (``types.mask_clients``);
* **checkpoints and auto-resumes**: the serving state is a fixed-shape
  tree written through ``CheckpointManager``'s COMMIT protocol;
  ``run_resumable`` drives scripted serving through
  ``distributed.fault.resumable_loop``.

Differential contract: a daemon that never serves a stale decision gives
an allocation stream **bitwise equal** to ``simulator.run_scan(
collect_alloc=True)`` fed the same admission trace (explicit ``arrivals``/
``counts``/``avail``) on the same seed and device.  The per-period math IS
``simulator._period_step``; period p draws from the generator
``run_scan``'s own sampler seeds for it, ``generator(seed + 7, p)``, with
the plane's current client counts, which ``sample_draws`` uses only as the
client mask; and inactive slots are masked whole, so the counts of slots
not admitted yet cannot move a bit of the active rows.

A tick copies the allocation to the host in two transfers: one of the
integers (rounds, activity, the count of non-finite values in each float
leaf of the carry, the solver's rescue count) and one of b and f.  The
carry is healed on the device, and only when that count is not zero.

The asyncio front end (request queue, solver-timeout degradation, the
``stale_decisions`` metric) lives in ``repro_torch.launch.allocd``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import scenarios, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import network, policy as policy_mod
from repro_torch.core.types import ServiceSet, default_device
from repro_torch.distributed import fault
from repro_torch.fl import simulator
from repro_torch.scenarios import GeneratorSource, generator

# Arrival sentinel for a slot no service has been admitted into: period
# numbers stay far below int32 max, so ``arrivals <= period`` is False
# forever.  The replay feeds run_scan the very same sentinel.
NEVER = np.int32(np.iinfo(np.int32).max)

@dataclasses.dataclass(frozen=True)
class ControlPlaneConfig:
    """Static configuration of one allocation daemon.

    Mirrors the ``SimConfig`` fields that select the period step
    (``replay_sim_config`` maps one onto the other).  ``capacity`` is the
    fixed slot count (admissions beyond it are rejected); ``k_max`` the
    per-slot client pad."""

    capacity: int = 16
    k_max: int = 32
    policy: str = "coop"
    warm_start: bool = True
    rounds_required: int = 2000
    seed: int = 0
    n_bids: int = 5
    alpha_fair: float = 0.5
    intra_backend: str = "reference"
    channel_process: str | scenarios.ScenarioSpec = "iid"
    churn_process: str | scenarios.ScenarioSpec = "none"
    # A client whose last heartbeat is more than this many periods old is
    # dropped from the next clear.  None disables liveness tracking (every
    # enrolled client stays up).
    heartbeat_timeout_periods: int | None = None


class Decision(NamedTuple):
    """One served per-period allocation over the fixed-capacity slots."""

    period: int
    b: np.ndarray          # (capacity,) MHz
    f: np.ndarray          # (capacity,) rounds/s
    active: np.ndarray     # (capacity,) bool
    stale: bool            # True: previous clear rescaled, not a fresh solve
    # True: the O(1) equal-share emergency policy (stale-streak overflow or
    # a non-finite solver output), flagged apart from plain staleness.
    degraded: bool = False


@functools.lru_cache(maxsize=None)
def _serve_step(policy, n_bids, alpha_fair, intra_backend, warm_start, net,
                rounds_required, channel, churn):
    """The daemon's period step: ``simulator._period_step`` bound to the
    statics the offline engines use, with the processes and the stateful
    policy built once per configuration (restarts and tests reuse them)."""
    pol = policy_mod.get_stateful_policy(
        policy, warm_start=warm_start, n_bids=n_bids, alpha_fair=alpha_fair,
        intra_backend=intra_backend)
    chan = scenarios.get_channel(channel, net)
    churn_proc = scenarios.get_churn(churn, net)
    step = functools.partial(
        simulator._period_step, policy_fn=pol.step, chan_step=chan.step,
        churn_step=churn_proc.step, chan_rebuilds=chan.rebuilds, net=net,
        rounds_required=rounds_required)
    return step, chan, churn_proc, pol


def _with_counts(sampler: Callable, counts: np.ndarray) -> Callable:
    """``sampler`` with each period's raw draws carrying ``counts`` as
    their client counts (a built ServiceSet passes as it is)."""
    counts = np.array(counts, np.int32)

    def draw(period: int):
        d = sampler(period)
        if isinstance(d, ServiceSet):
            return d
        if isinstance(d.services, network.ServiceDraws):
            dev = d.services.eps_client.device
            d = d._replace(services=d.services._replace(
                client_counts=torch.as_tensor(counts, device=dev)))
        return d

    return draw


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class _SlotRecord:
    service_id: Any
    slot: int
    n_clients: int
    admitted_period: int
    retired_period: int | None = None


class ControlPlane:
    """Synchronous serving core: slot registry + period step + state.

    All state transitions happen in ``tick`` (one period each); the asyncio
    daemon in ``launch.allocd`` layers batched request draining and
    solver-timeout degradation on top.  The plane runs on ``device``
    (default: the card).  ``sampler(period)`` replaces the period's draws
    as in ``run_scan`` (the plane puts its current client counts into
    them); the initial states then come from ``sampler(0).init``.
    """

    def __init__(self, cfg: ControlPlaneConfig,
                 net: network.NetworkConfig | None = None, *, device=None,
                 sampler: Callable | None = None):
        if cfg.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.cfg = cfg
        self.net = net or network.NetworkConfig()
        self.device = (torch.device(device) if device is not None
                       else default_device())
        self._sampler = sampler
        self._step, self._chan, churn, pol = _serve_step(
            cfg.policy, cfg.n_bids, cfg.alpha_fair, cfg.intra_backend,
            cfg.warm_start, self.net, cfg.rounds_required,
            scenarios.as_spec(cfg.channel_process, "iid"),
            scenarios.as_spec(cfg.churn_process, "none"))
        # The draws' configuration: run_scan's on the same seed.
        self._draw_cfg = simulator.SimConfig(
            n_services_total=cfg.capacity, k_max=cfg.k_max, seed=cfg.seed,
            channel_process=cfg.channel_process)
        n, k = cfg.capacity, cfg.k_max
        self._arrivals = np.full((n,), NEVER, np.int32)
        self._counts = np.zeros((n,), np.int32)
        self._last_seen = np.zeros((n, k), np.int32)
        self._period = 0
        init = sampler(0).init if sampler is not None else None
        init = init or GeneratorSource(self.device, cfg.seed + 7)
        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self._carry = (zeros, zeros.clone(), self._chan.init(init, n, k),
                       churn.init(init, n, k),
                       pol.init_state(n, self.device))
        self._rounds_done = np.zeros((n,), np.int32)
        self.services: dict[Any, _SlotRecord] = {}
        self.retired: list[_SlotRecord] = []
        self._free = np.ones((n,), bool)       # (capacity,) free-slot mask
        self.replayable = True      # falsified by slot reuse / forced retire
        self.unreplayable_reasons: list[str] = []
        # period -> [[slot, client], ...] heartbeat-timeout drops, recorded
        # so a masked episode still replays bitwise (run_scan's ``avail``).
        self._hb_drops: dict[int, list[list[int]]] = {}
        self.metrics = {
            "decisions": 0, "stale_decisions": 0, "admitted": 0,
            "retired": 0, "rejected": 0, "heartbeat_drops": 0,
            # Robustness counters: none of these moves on a healthy run;
            # each marks a counted, never silent, degradation.
            "solver_fallbacks": 0, "nonfinite_decisions": 0,
            "degraded_decisions": 0, "carry_repairs": 0,
            "checkpoint_skips": 0, "admit_retries": 0,
        }
        self.decisions: list[Decision] = []

    def _mark_unreplayable(self, reason: str) -> None:
        self.replayable = False
        if reason not in self.unreplayable_reasons:
            self.unreplayable_reasons.append(reason)

    # -- admission / retirement -------------------------------------------

    @property
    def period(self) -> int:
        """Periods cleared so far (the next tick's period index)."""
        return self._period

    @property
    def free_slots(self) -> int:
        return int(self._free.sum())

    def admit(self, service_id, n_clients: int) -> int:
        """Admit a service into the lowest free slot, active from the period
        of the *next* ``tick``.  Raises when full or on a duplicate id (the
        daemon maps that onto an explicit rejection)."""
        if service_id in self.services:
            raise ValueError(f"service {service_id!r} already admitted")
        if not 1 <= n_clients <= self.cfg.k_max:
            raise ValueError(
                f"n_clients must be in [1, {self.cfg.k_max}], got {n_clients}")
        if not self._free.any():
            self.metrics["rejected"] += 1
            raise RuntimeError(
                f"all {self.cfg.capacity} slots occupied; retire a service "
                f"or grow capacity")
        # Prefer the lowest never-used slot: reusing a freed one makes the
        # episode inexpressible as a single run_scan (arrival, count) trace.
        virgin = np.flatnonzero(self._free & (self._arrivals == NEVER))
        slot = int(virgin[0] if virgin.size else np.flatnonzero(self._free)[0])
        self._free[slot] = False
        if self._arrivals[slot] != NEVER:
            self._mark_unreplayable("slot reuse")
        self._arrivals[slot] = self._period
        self._counts[slot] = n_clients
        self._last_seen[slot, :] = self._period
        self.services[service_id] = _SlotRecord(
            service_id, slot, n_clients, self._period)
        self.metrics["admitted"] += 1
        return slot

    def retire(self, service_id) -> None:
        """Forced (client-requested) retirement: the slot goes inactive from
        the next period and returns to the free list.  Completion-based
        departures need no request: ``tick`` detects them."""
        rec = self.services.pop(service_id, None)
        if rec is None:
            raise KeyError(f"unknown service {service_id!r}")
        self._arrivals[rec.slot] = NEVER
        self._free[rec.slot] = True
        rec.retired_period = self._period
        self.retired.append(rec)
        self.metrics["retired"] += 1
        self._mark_unreplayable("forced retire")
        self._counts[rec.slot] = 0

    # -- heartbeats --------------------------------------------------------

    def heartbeat(self, service_id, client: int | None = None) -> None:
        """Record liveness for one client (or the whole cohort) of a
        service, stamped at the current period."""
        rec = self.services.get(service_id)
        if rec is None:
            raise KeyError(f"unknown service {service_id!r}")
        if client is None:
            self._last_seen[rec.slot, :] = self._period
        else:
            if not 0 <= client < rec.n_clients:
                raise ValueError(
                    f"client {client} out of range for service "
                    f"{service_id!r} ({rec.n_clients} clients)")
            self._last_seen[rec.slot, client] = self._period

    def _heartbeat_mask(self) -> np.ndarray | None:
        """(capacity, k_max) availability from heartbeat ages, or None when
        no client is dropped this period (liveness tracking off, or every
        live client heard from): the step then masks nothing.

        Only drops of *live, enrolled* clients can perturb the clear:
        inactive rows are zeroed whole by the activity rule and columns
        ``k >= counts`` by the base client mask, so everything else is
        forced True.  The drops are recorded per period in ``_hb_drops``,
        which ``replay_reference`` feeds back through ``run_scan(avail=)``
        (where an all-True period masks nothing either: the mask only
        clears bits of an already masked set)."""
        timeout = self.cfg.heartbeat_timeout_periods
        if timeout is None:
            return None
        avail = (self._period - self._last_seen) <= timeout
        live = np.zeros((self.cfg.capacity, 1), bool)
        for rec in list(self.services.values()):
            live[rec.slot, 0] = True
        enrolled = np.arange(self.cfg.k_max)[None, :] < self._counts[:, None]
        eff = np.where(live & enrolled, avail, True)
        dropped = int(np.sum(~eff))
        self.metrics["heartbeat_drops"] += dropped
        if not dropped:
            return None
        slots, clients = np.nonzero(~eff)
        self._hb_drops[self._period] = [
            [int(s), int(c)] for s, c in zip(slots, clients)]
        return eff

    # -- the period step ---------------------------------------------------

    def _draws(self, period: int) -> simulator.PeriodDraws:
        """Period ``period``'s draws with the current client counts."""
        if self._sampler is not None:
            return simulator._period_draws(
                _with_counts(self._sampler, self._counts), period,
                self._draw_cfg, self.device, self._chan)
        raw = network.sample_draws(
            generator(self.cfg.seed + 7, period), self.cfg.capacity,
            self.net, k_max=self.cfg.k_max,
            client_counts=torch.tensor(self._counts))
        return simulator._placed(raw, self._draw_cfg, period, self.device)

    def tick(self) -> Decision:
        """Run one period: heartbeat-derived churn, the clear,
        completion-based retirement, trace bookkeeping.

        Hardened: a non-finite solver output is never served (the period
        degrades to the O(1) equal-share decision, counted in
        ``nonfinite_decisions``); non-finite values left in the carry are
        healed afterwards (``carry_repairs``) so one poisoned period
        cannot cascade; the warm solver's cold-bisection rescues are
        mirrored from the policy carry into ``solver_fallbacks``.  Each of
        those also falsifies ``replayable``: an injected fault is not part
        of the recorded trace."""
        period = self._period
        hb = self._heartbeat_mask()
        n = self.cfg.capacity
        (rounds_done, duration, chan_state, churn_state, pol_state, _,
         extras) = self._step(
            *self._carry, period,
            torch.tensor(self._arrivals, device=self.device),
            self._draws(period),
            None if hb is None else torch.as_tensor(hb).to(self.device))
        self._carry = (rounds_done, duration, chan_state, churn_state,
                       pol_state)
        leaves = tree.leaves(self._carry)
        floats = [leaf for leaf in leaves if leaf.is_floating_point()]
        fallbacks = (pol_state.fallbacks
                     if isinstance(pol_state, policy_mod.WarmDualState)
                     else torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        ints = torch.cat([
            rounds_done.to(torch.int64), extras["active"].to(torch.int64),
            *(torch.sum(~torch.isfinite(x)).reshape(1) for x in floats),
            fallbacks.to(torch.int64).reshape(1)]).cpu().numpy()
        bf = torch.cat([extras["b"], extras["f"]]).cpu().numpy()
        b, f = bf[:n], bf[n:]
        active = ints[n:2 * n].astype(bool)
        self._rounds_done = ints[:n].astype(np.int32)
        self._period = period + 1
        self._retire_finished()
        if int(ints[-1]) > self.metrics["solver_fallbacks"]:
            self.metrics["solver_fallbacks"] = int(ints[-1])
            self._mark_unreplayable("solver fallback (non-finite inputs)")
        if self._repair_carry(ints[2 * n:-1]):
            self._mark_unreplayable("carry repaired after non-finite values")
        if not (np.all(np.isfinite(b)) and np.all(np.isfinite(f))):
            self.metrics["nonfinite_decisions"] += 1
            self.metrics["degraded_decisions"] += 1
            self._mark_unreplayable("non-finite solver output")
            decision = self._equal_share(period, stale=False)
        else:
            decision = Decision(period=period, b=b, f=f, active=active,
                                stale=False)
        self.metrics["decisions"] += 1
        self.decisions.append(decision)
        return decision

    def _repair_carry(self, bad: np.ndarray) -> int:
        """Replace the non-finite entries of the carry's float leaves
        (``bad``: their counts, leaf by leaf) with 0 (for the warm dual
        price, 0 means "cold seed next period").  Returns the number of
        entries healed, added to ``metrics['carry_repairs']``: 0 on every
        healthy tick, which touches nothing."""
        healed = int(bad.sum())
        if healed:
            counts = iter(bad)
            out = []
            for leaf in tree.leaves(self._carry):
                if leaf.is_floating_point() and next(counts):
                    leaf = torch.where(torch.isfinite(leaf), leaf,
                                       torch.zeros_like(leaf))
                out.append(leaf)
            self._carry = tree.unflatten(self._carry, out)
            self.metrics["carry_repairs"] += healed
        return healed

    def _retire_finished(self) -> None:
        """Completion-based departure (the simulator's own rule): a service
        whose rounds_done reached rounds_required frees its slot.  The
        arrival/count arrays are left untouched: the step's activity rule
        already excludes the row, and the replay needs the history."""
        done = self._rounds_done >= self.cfg.rounds_required
        for sid in [s for s, r in self.services.items() if done[r.slot]]:
            rec = self.services.pop(sid)
            rec.retired_period = self._period
            self.retired.append(rec)
            self._free[rec.slot] = True
            self.metrics["retired"] += 1

    def _occupied(self) -> np.ndarray:
        """(capacity,) live-slot mask from the registry.  Snapshots the
        registry values first: the daemon may call this from the event loop
        while a tick commits in an executor thread."""
        occupied = np.zeros((self.cfg.capacity,), bool)
        for rec in list(self.services.values()):
            occupied[rec.slot] = True
        return occupied

    def stale_decision(self) -> Decision:
        """Degraded decision for the current period: the previous clear
        rescaled to the live admission mask (budget-preserving), used by the
        daemon when the solver misses its deadline.  Counted in
        ``metrics['stale_decisions']`` and NOT appended to ``decisions``,
        the fresh-solve stream the differential replay checks."""
        period = self._period
        occupied = self._occupied()
        self.metrics["stale_decisions"] += 1
        if not self.decisions:
            # Nothing cleared yet: equal split over live slots.
            return self._equal_share(period, stale=True)
        prev = self.decisions[-1]
        b = np.where(occupied, prev.b, 0.0)
        total = float(b.sum())
        if total > 0.0:
            b = b * (self.net.total_bandwidth_mhz / total)
        f = np.where(occupied, prev.f, 0.0)
        return Decision(period=period, b=b.astype(np.float32),
                        f=f.astype(np.float32), active=occupied, stale=True)

    def _equal_share(self, period: int, *, stale: bool,
                     count: bool = False) -> Decision:
        """The O(1) emergency allocation: B split equally over live slots,
        f = 0 (no solve ran, so no frequency claim is honest)."""
        occupied = self._occupied()
        n_live = max(int(occupied.sum()), 1)
        b = np.where(occupied, self.net.total_bandwidth_mhz / n_live, 0.0)
        f = np.zeros((self.cfg.capacity,), np.float32)
        if count:
            self.metrics["degraded_decisions"] += 1
        return Decision(period=period, b=b.astype(np.float32), f=f,
                        active=occupied, stale=stale, degraded=True)

    def degraded_decision(self) -> Decision:
        """Emergency decision for the current period: equal share over the
        live mask, used by the daemon once a stale streak exceeds its bound.
        Counted in ``metrics['degraded_decisions']``, flagged ``degraded``
        and, like ``stale_decision``, not appended to ``decisions``."""
        return self._equal_share(self._period, stale=True, count=True)

    def allocation_of(self, service_id) -> dict:
        """Latest served (b, f) for one admitted service."""
        rec = self.services.get(service_id)
        if rec is None:
            raise KeyError(f"unknown service {service_id!r}")
        if not self.decisions:
            raise RuntimeError("no decision served yet")
        last = self.decisions[-1]
        return {"period": last.period, "b_mhz": float(last.b[rec.slot]),
                "f_rounds_per_s": float(last.f[rec.slot]),
                "stale": last.stale}

    # -- differential replay ----------------------------------------------

    def trace(self) -> tuple[np.ndarray, np.ndarray]:
        """The admission trace as run_scan inputs: per-slot (arrivals,
        counts), with ``NEVER`` marking slots no service ever occupied."""
        return self._arrivals.copy(), self._counts.copy()

    def replay_sim_config(self) -> simulator.SimConfig:
        """The SimConfig whose ``run_scan(arrivals=..., counts=...,
        collect_alloc=True)`` replays this daemon's stream bitwise."""
        return simulator.SimConfig(
            policy=self.cfg.policy, n_services_total=self.cfg.capacity,
            rounds_required=self.cfg.rounds_required, seed=self.cfg.seed,
            k_max=self.cfg.k_max, max_periods=max(self._period, 1),
            n_bids=self.cfg.n_bids, alpha_fair=self.cfg.alpha_fair,
            intra_backend=self.cfg.intra_backend,
            warm_start=self.cfg.warm_start,
            channel_process=self.cfg.channel_process,
            churn_process=self.cfg.churn_process,
            collect_history=True, collect_alloc=True,
        )

    def recorded_avail(self) -> np.ndarray | None:
        """The recorded heartbeat-drop stream as run_scan's ``avail`` tensor
        ((period, capacity, k_max) bool), or None when no drop was ever
        recorded."""
        if not self._hb_drops:
            return None
        avail = np.ones((max(self._period, 1), self.cfg.capacity,
                         self.cfg.k_max), bool)
        for p, drops in self._hb_drops.items():
            if p < avail.shape[0]:
                for slot, client in drops:
                    avail[p, slot, client] = False
        return avail

    def replay_reference(self) -> dict:
        """Run the offline engine on this daemon's recorded trace
        (admissions + heartbeat-drop masks), on its device and draws."""
        if not self.replayable:
            raise RuntimeError(
                "trace is not replayable as one run_scan episode (slot "
                "reuse, forced retire, or an injected fault: "
                f"{self.unreplayable_reasons or 'unknown'})")
        arrivals, counts = self.trace()
        sampler = (None if self._sampler is None
                   else _with_counts(self._sampler, counts))
        return simulator.run_scan(self.replay_sim_config(), self.net,
                                  arrivals=arrivals, counts=counts,
                                  avail=self.recorded_avail(),
                                  sampler=sampler, device=self.device)

    # -- checkpointable state ---------------------------------------------

    def state_pytree(self) -> dict:
        """The full serving state as one fixed-shape tree (COMMIT-protocol
        checkpointable; shapes depend only on the config).  It holds no
        RNG state: the draws re-derive from (seed, period)."""
        return {
            "period": torch.tensor(self._period, dtype=torch.int32),
            "arrivals": torch.from_numpy(self._arrivals.copy()),
            "counts": torch.from_numpy(self._counts.copy()),
            "last_seen": torch.from_numpy(self._last_seen.copy()),
            "carry": self._carry,
        }

    def registry_meta(self) -> dict:
        """JSON side-channel for ``CheckpointManager.save(extra=...)``: the
        service-id -> slot map the tree cannot carry, and the draw stream
        the state was served under."""
        return {
            "services": {
                str(s): dataclasses.asdict(r)
                for s, r in self.services.items()
            },
            "metrics": dict(self.metrics),
            "replayable": self.replayable,
            "unreplayable_reasons": list(self.unreplayable_reasons),
            "hb_drops": {str(p): d for p, d in self._hb_drops.items()},
            "draw_stream": simulator.DRAW_STREAM,
        }

    def snapshot(self, manager: CheckpointManager) -> None:
        """COMMIT-protocol checkpoint of serving state + registry meta."""
        manager.save(self._period, self.state_pytree(),
                     extra=self.registry_meta())

    def restore(self, manager: CheckpointManager) -> bool:
        """Adopt the newest VERIFIABLE checkpoint; False when none survives.
        Corrupted-but-committed steps the manager had to skip are counted
        in ``metrics['checkpoint_skips']``."""
        step, state, extra = manager.restore_latest(self.state_pytree())
        skipped = len(getattr(manager, "last_skipped", ()))
        if step is None:
            self.metrics["checkpoint_skips"] += skipped
            return False
        self.load_state(state, extra)
        self.metrics["checkpoint_skips"] += skipped
        return True

    def load_state(self, state: dict, meta: dict | None = None) -> None:
        """Adopt a checkpointed tree (and optionally the registry meta).

        Without ``meta`` the registry is rebuilt from the arrays alone
        (slot indices become the service ids), which is what the scripted
        ``run_resumable`` path needs after a crash.  A ``meta`` written
        under another draw stream (the JAX package's, or none recorded)
        is adopted all the same, but the plane's later draws no longer
        continue the stream behind its progress: it is marked
        unreplayable, and keeps serving."""
        self._period = int(_host(state["period"]))
        self._arrivals = _host(state["arrivals"]).astype(np.int32).copy()
        self._counts = _host(state["counts"]).astype(np.int32).copy()
        self._last_seen = _host(state["last_seen"]).astype(np.int32).copy()
        self._carry = tuple(state["carry"])
        self._rounds_done = _host(self._carry[0]).astype(np.int32)
        self.services.clear()
        self._hb_drops = {}
        if meta and "services" in meta:
            for rec in meta["services"].values():
                rec = _SlotRecord(**rec)
                self.services[rec.service_id] = rec
            if "metrics" in meta:
                self.metrics.update(meta["metrics"])
            self.replayable = bool(meta.get("replayable", True))
            self.unreplayable_reasons = list(
                meta.get("unreplayable_reasons", []))
            self._hb_drops = {int(p): [[int(s), int(c)] for s, c in drops]
                              for p, drops in meta.get("hb_drops",
                                                       {}).items()}
            occupied = {r.slot for r in self.services.values()}
        else:
            occupied = set()
            live = np.logical_and(self._arrivals != NEVER,
                                  self._rounds_done < self.cfg.rounds_required)
            for slot in np.flatnonzero(live):
                slot = int(slot)
                self.services[slot] = _SlotRecord(
                    service_id=slot, slot=slot,
                    n_clients=int(self._counts[slot]),
                    admitted_period=int(self._arrivals[slot]))
                occupied.add(slot)
            if (self.cfg.heartbeat_timeout_periods is not None
                    and self._period > 0):
                # The array-only restore path has no heartbeat-drop record,
                # so a liveness-tracked episode cannot be replayed soundly.
                self._mark_unreplayable(
                    "restored without a heartbeat-drop record")
        if meta is not None and meta.get("draw_stream") != \
                simulator.DRAW_STREAM:
            self._mark_unreplayable("restored from another draw stream")
        self._free = np.ones((self.cfg.capacity,), bool)
        self._free[sorted(occupied)] = False


# ---------------------------------------------------------------------------
# Scripted serving through the fault-tolerance layer.
# ---------------------------------------------------------------------------

def run_resumable(
    cfg: ControlPlaneConfig,
    schedule: dict[int, tuple[int, ...]],
    n_periods: int,
    manager: CheckpointManager,
    policy: fault.RestartPolicy | None = None,
    fail_at: int | None = None,
    net: network.NetworkConfig | None = None,
    *, device=None, sampler: Callable | None = None,
) -> tuple[dict, ControlPlane]:
    """Drive a scripted admission schedule through
    ``fault.resumable_loop``: one resumable step per period, the serving
    state checkpointed every ``policy.save_every`` periods.  ``schedule``
    maps period -> client counts of the services to admit that period (ids
    ``p{period}s{i}``).  A crashed-and-restarted run reaches a
    bit-identical final state and loses at most ``save_every - 1``
    periods of work.

    Returns ``(final state tree, the replayed ControlPlane)``: the plane's
    bookkeeping is rebuilt by ``load_state``, so its ``trace()`` still
    feeds the differential replay.
    """
    plane = ControlPlane(cfg, net, device=device, sampler=sampler)

    def step(state, t):
        plane.load_state(state)
        for i, n_clients in enumerate(schedule.get(t, ())):
            if plane.free_slots:
                plane.admit(f"p{t}s{i}", n_clients)
        plane.tick()
        return plane.state_pytree()

    final = fault.resumable_loop(step, plane.state_pytree(), n_periods,
                                 manager, policy, fail_at=fail_at)
    plane.load_state(final)
    return final, plane
