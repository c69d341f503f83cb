"""(seed, period, channel)-keyed randomness for replayable fault injection.

Every injector draw comes from a PCG64 stream seeded with the tuple
``(ROOT_SALT, storm seed, period, crc32(channel))``: no global RNG state,
no draw-order coupling between injectors, no platform-dependent hashing
(``zlib.crc32``, unlike ``hash``, is stable across processes).  Two storms
with the same seed therefore make identical draws at every (period,
channel) whichever other injectors ran, so a recorded failure trajectory
replays exactly from its seed.  Numpy only: the draws equal the JAX
package's ``repro.chaos.schedule`` bit for bit.
"""
from __future__ import annotations

import zlib

import numpy as np

ROOT_SALT = 0xC4A05EED


class ChaosSchedule:
    """Deterministic per-(period, channel) RNG factory for one storm."""

    def __init__(self, seed: int):
        self.seed = int(seed) & 0xFFFFFFFF

    def rng(self, period: int, channel: str) -> np.random.Generator:
        """A fresh generator for this (period, channel), independent of
        every other channel and of how many draws anyone else made."""
        return np.random.default_rng(
            [ROOT_SALT, self.seed, int(period) & 0xFFFFFFFF,
             zlib.crc32(channel.encode("utf-8"))])

    def fires(self, period: int, channel: str, p: float) -> bool:
        """One Bernoulli(p) draw on the channel's dedicated stream."""
        return bool(self.rng(period, channel).random() < p)
