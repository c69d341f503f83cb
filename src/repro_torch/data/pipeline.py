"""Synthetic-but-learnable data pipeline.

``SyntheticLM`` generates token sequences from a fixed random bigram chain
(next ~ Cat(softmax(T[prev])), T = normal / temperature from the seed), so
a model has real signal to fit without any dataset.  A batch is a
deterministic function of (seed, step, client) alone: every uniform comes
from a counter-based hash of (seed, step, client, row, position), and each
token is drawn by inverse CDF against the chain's row CDFs, computed once
in float64.  Every float operation runs on the host CPU, so the stream is
the same whichever device trains on it, and ``batches`` draws a whole
round's clients in one vectorised pass.

The stream is this package's own: the reference package draws its chain
with threefry, which torch cannot replay, so a differential test hands the
reference's batches in (any object with ``batch`` and ``batches``).

``dirichlet_partition`` splits class-like token groups across FL clients
with a Dirichlet(alpha) prior: the standard non-IID federated split.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.scenarios import generator

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
# Salt of the batch stream's words (the chain's table is generator(seed)).
_BATCH_SALT = 0x5EED


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 arrays (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _uniforms(*words) -> np.ndarray:
    """float64 uniforms in [0, 1) hashed from broadcast integer words."""
    arrays = np.broadcast_arrays(*(np.asarray(w, dtype=np.int64)
                                   for w in words))
    with np.errstate(over="ignore"):
        h = np.zeros(arrays[0].shape, np.uint64)
        for w in arrays:
            h = _mix(h ^ w.astype(np.uint64))
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Bigram-chain language: next ~ Cat(softmax(T[prev])), T fixed by
    seed."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    temperature: float = 0.7

    def transition_logits(self) -> torch.Tensor:
        """(V, V) float32 logits T: normal(generator(seed)) / temperature,
        drawn on the CPU."""
        z = torch.randn((self.vocab_size, self.vocab_size),
                        generator=generator(self.seed))
        return z / self.temperature

    @functools.cached_property
    def _cdf(self) -> np.ndarray:
        """(V, V - 1) float64 row CDFs of softmax(T) without their last
        entry: the boundaries a uniform passes."""
        logits = self.transition_logits().numpy().astype(np.float64)
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        return np.cumsum(p, axis=1)[:, :-1]

    def _sequences(self, steps, client_ids, batch_size: int) -> np.ndarray:
        """(M, B, S + 1) int64 token chains of M (step, client) pairs."""
        steps = np.asarray(steps, np.int64).reshape(-1, 1, 1)
        clients = np.asarray(client_ids, np.int64).reshape(-1, 1, 1)
        rows = np.arange(batch_size, dtype=np.int64).reshape(1, -1, 1)
        pos = np.arange(self.seq_len + 1, dtype=np.int64).reshape(1, 1, -1)
        u = _uniforms(self.seed, _BATCH_SALT, steps, clients, rows, pos)
        seq = np.empty(u.shape, np.int64)
        seq[..., 0] = np.minimum((u[..., 0] * self.vocab_size).astype(
            np.int64), self.vocab_size - 1)
        cdf = self._cdf
        for t in range(1, self.seq_len + 1):
            seq[..., t] = np.sum(cdf[seq[..., t - 1]] <= u[..., t, None],
                                 axis=-1)
        return seq

    def batches(self, step, batch_size: int, client_ids) -> dict:
        """Batches of many clients at once: ``client_ids`` any int array,
        ``step`` an int or an int array of its shape.  Returns CPU int64
        ``tokens`` and next-token ``labels`` of shape client_ids.shape +
        (batch_size, seq_len)."""
        client_ids = np.asarray(client_ids, np.int64)
        steps = np.broadcast_to(np.asarray(step, np.int64), client_ids.shape)
        seq = self._sequences(steps.reshape(-1), client_ids.reshape(-1),
                              batch_size)
        seq = torch.from_numpy(seq.reshape(
            client_ids.shape + (batch_size, self.seq_len + 1)))
        return {"tokens": seq[..., :-1], "labels": seq[..., 1:]}

    def batch(self, step: int, batch_size: int, client_id: int = 0) -> dict:
        """Deterministic batch for (step, client): (B, S) tokens and
        next-token labels; the client's slice of ``batches``."""
        out = self.batches(step, batch_size, np.array([client_id]))
        return {k: v[0] for k, v in out.items()}


def dirichlet_partition(seed: int, n_samples: int, n_clients: int,
                        n_classes: int, alpha: float = 0.5) -> torch.Tensor:
    """Assign each of ``n_samples`` (sample class = i % n_classes) to a
    client through per-class Dirichlet(alpha) proportions, drawn from a
    numpy generator seeded with ``seed``.  Returns (n_samples,) int64
    client ids; a smaller alpha makes clients more skewed."""
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(alpha * np.ones(n_clients), size=n_classes)
    classes = np.arange(n_samples) % n_classes
    cdf = np.cumsum(props, axis=1)[:, :-1]
    u = rng.random(n_samples)
    return torch.from_numpy(np.sum(cdf[classes] <= u[:, None], axis=1))


def federated_batches(source: SyntheticLM, step: int, client_ids,
                      batch_size: int) -> dict:
    """Stacked per-client batches: (n_clients, B, S) tokens and labels."""
    return source.batches(step, batch_size, np.asarray(client_ids))
