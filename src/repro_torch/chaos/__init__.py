"""Deterministic, seeded chaos engineering for the allocation stack.

Composable fault injectors over the live control plane and daemon
(``fl.control_plane`` / ``launch.allocd``), every draw keyed on ``(seed,
period, channel)`` so any failure trajectory replays exactly from its seed
(``schedule.ChaosSchedule``, numpy: the JAX package's draws bit for bit).
The injector catalogue (``injectors``): heartbeat faults (drop / delay /
duplicate / flap), solver faults (deterministic deadline misses,
NaN/Inf-poisoned channel state, badly-stale or non-finite warm dual
seeds), checkpoint faults (torn COMMIT, corrupted / truncated shards
behind an intact COMMIT, restart storms), and admission faults (bursts,
duplicate admits, retire-of-unknown).

``engine.run_storm`` drives a storm and returns a JSON-able report with a
trajectory digest (same seed -> identical digest); ``invariants.verify``
checks the safety net under every schedule: budget conservation, no
non-finite value ever served, retired slots never allocated, and the
recorded trace replaying bitwise through ``simulator.run_scan``.

Adversarial *participants* ride the same channels: ``clients.ClientChaos``
turns a seeded fraction of FL clients Byzantine (channel
``byz/<service>``) against the ``fl.aggregation`` registry, and
``bids.BidChaos`` plays seeded unilateral deviations against the
auction's Prop. 5 truthfulness gap (channel ``bid``).  ``invariants`` has
the matching gates (``accuracy_bounded`` / ``params_finite`` /
``regret_bounded`` / ``assert_robust``).
"""
from repro_torch.chaos.schedule import ChaosSchedule
from repro_torch.chaos.injectors import (AdmissionChaos, CheckpointChaos,
                                         HeartbeatChaos, Injector,
                                         SolverChaos, poison_channel_state,
                                         poison_warm_seed)
from repro_torch.chaos.clients import AttackSpec, ClientChaos
from repro_torch.chaos.bids import BidChaos
from repro_torch.chaos.engine import ChaosEngine, default_injectors, run_storm
from repro_torch.chaos import invariants

__all__ = [
    "ChaosSchedule", "Injector", "HeartbeatChaos", "SolverChaos",
    "CheckpointChaos", "AdmissionChaos", "poison_channel_state",
    "poison_warm_seed", "AttackSpec", "ClientChaos", "BidChaos",
    "ChaosEngine", "default_injectors", "run_storm", "invariants",
]
