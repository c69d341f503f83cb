"""Adversarial-participant chaos: seeded Byzantine clients for the
co-training loop.

``ClientChaos`` attacks the *participants*: a seeded fraction of client
slots per service turns Byzantine and manipulates what it uploads to the
FedAvg server.  Membership draws ride the same ``(ROOT_SALT, seed,
period, crc32(channel))`` scheme as every other chaos channel
(``schedule.ChaosSchedule``, channel ``byz/<service>``), so an attacked
training trajectory replays bitwise from ``AttackSpec.seed`` alone, and,
the channels being disjoint from the simulator's draws, the attack cannot
perturb the allocation side of the episode.  The plan is drawn with numpy
on the host, equal to the JAX package's bit for bit.

The catalogue (Fang et al. 2020 / Blanchard et al. 2017 standards):

* ``sign_flip``      Byzantine deltas become ``-scale * delta`` (scaled
                     gradient reversal).
* ``scaled_delta``   deltas become ``scale * delta`` (model boosting).
* ``same_value``     collusion: every Byzantine client uploads the same
                     constant-``scale`` tensor.
* ``nan``            a NaN upload; poisons any unmasked reduction.
* ``inflate_weight`` honest-looking delta, weight multiplied by ``scale``
                     (dominates an uncapped weighted mean; see
                     ``server.sanitize_weights``).

``attack_fn`` is the per-round transformation on tensors, given the
round's (C,) Byzantine mask; it is ``torch.func.vmap``-safe.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.chaos.schedule import ChaosSchedule
from repro_torch.tree import tree_map

ATTACKS = ("sign_flip", "scaled_delta", "same_value", "nan", "inflate_weight")


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """Hashable description of an adversarial client cohort."""

    attack: str = "sign_flip"
    byz_frac: float = 0.2    # per-slot Bernoulli membership probability
    scale: float = 8.0       # attack magnitude (see the catalogue above)
    seed: int = 0            # ChaosSchedule storm seed for membership draws

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(
                f"unknown client attack {self.attack!r}; known: {ATTACKS}")
        if not 0.0 <= self.byz_frac <= 1.0:
            raise ValueError(
                f"byz_frac must be in [0, 1], got {self.byz_frac}")


class ClientChaos:
    """Deterministic Byzantine-membership planner for one attacked episode."""

    name = "clients"

    def __init__(self, spec: AttackSpec):
        self.spec = spec
        self.schedule = ChaosSchedule(spec.seed)

    def plan(self, n_periods: int, n_services: int, k_max: int) -> np.ndarray:
        """(T, N, K) bool Byzantine membership: per period and service, each
        client slot turns Byzantine with probability ``byz_frac`` on the
        dedicated ``byz/<service>`` channel, independent of every other
        chaos channel and replayable from the spec's seed."""
        out = np.zeros((n_periods, n_services, k_max), dtype=bool)
        for t in range(n_periods):
            for s in range(n_services):
                draws = self.schedule.rng(t, f"byz/{s}").random(k_max)
                out[t, s] = draws < self.spec.byz_frac
        return out


def attack_fn(spec: AttackSpec):
    """``(deltas, weights, byz) -> (deltas, weights)`` applied between the
    clients' local updates and the aggregator: ``deltas`` a tree of (C,
    ...) tensors, ``weights`` (C,), ``byz`` the round's (C,) bool
    membership.  Honest clients pass through bitwise."""

    def mask(byz, leaf):
        return byz.reshape((-1,) + (1,) * (leaf.dim() - 1))

    def apply(deltas, weights, byz):
        s = spec.scale
        if spec.attack == "sign_flip":
            deltas = tree_map(
                lambda d: torch.where(mask(byz, d), -s * d, d), deltas)
        elif spec.attack == "scaled_delta":
            deltas = tree_map(
                lambda d: torch.where(mask(byz, d), s * d, d), deltas)
        elif spec.attack == "same_value":
            deltas = tree_map(
                lambda d: torch.where(mask(byz, d), torch.full_like(d, s),
                                      d), deltas)
        elif spec.attack == "nan":
            deltas = tree_map(
                lambda d: torch.where(mask(byz, d),
                                      torch.full_like(d, float("nan")), d),
                deltas)
        elif spec.attack == "inflate_weight":
            weights = torch.where(
                torch.logical_and(byz, weights > 0),
                weights * torch.tensor(s, dtype=weights.dtype,
                                       device=weights.device), weights)
        return deltas, weights

    return apply
