"""Uplink compression of client deltas, with error feedback.

Compression shrinks the UT payload s^UT, which feeds back into the
allocator's alpha_{n,k} = s^DT/r^DT + s^UT/r^UT.  The co-simulation
(``cotrain``) prices a service's level into the ServiceSet's dynamic
s^UT column (``types.scale_uplink``) with ``compression_ratio`` before the
allocator runs, and the round step applies the same level's lossy operator
to the uploaded deltas.

Top-k magnitude sparsification (per leaf) and symmetric int8 quantization,
each with client-held error-feedback residuals: the part a round withheld
is added back to the next round's delta.  Every operator is written for
``torch.func.vmap`` (no data-dependent Python control flow), so the
server maps it over clients and services.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.tree import tree_map

# The registered methods, in the order the co-simulation's per-service
# branch ids use ("none" is always id 0).
METHODS = ("none", "topk", "int8", "topk_int8")


def _add_residual(delta, residual):
    return tree_map(lambda d, r: d + r.to(d.dtype), delta, residual)


def topk_sparsify(delta, k_frac: float, residual=None):
    """Keep the top ``k_frac`` fraction (by magnitude) of each leaf:
    exactly k = max(1, int(size * k_frac)) entries, ties to the lowest
    index (a stable sort of -|x|, as the reference's ``lax.top_k`` breaks
    them).  Returns (sparse_delta, new_residual)."""
    if residual is not None:
        delta = _add_residual(delta, residual)

    def one(x):
        flat = x.reshape(-1)
        k = max(1, int(flat.numel() * k_frac))
        idx = torch.argsort(-torch.abs(flat), stable=True)[:k]
        kept = torch.zeros_like(flat).scatter(0, idx, flat.gather(0, idx))
        return kept.reshape(x.shape)

    sparse = tree_map(one, delta)
    return sparse, tree_map(lambda d, s: d - s, delta, sparse)


def int8_quantize(delta, residual=None):
    """Symmetric per-leaf int8 quantization (round half to even, as the
    reference's ``jnp.round``).  Returns (dequantized, residual)."""
    if residual is not None:
        delta = _add_residual(delta, residual)

    def one(x):
        scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
        return torch.clamp(torch.round(x / scale), -127, 127) * scale

    deq = tree_map(one, delta)
    return deq, tree_map(lambda d, s: d - s, delta, deq)


def compress(method: str, delta, k_frac: float = 0.01, residual=None):
    """Apply ``method`` to a delta tree.  Returns (compressed, residual').

    ``"none"`` is the identity; under error feedback it flushes the carried
    residual into the upload (and returns a zero residual).
    ``"topk_int8"`` composes the two lossy stages under one residual, which
    absorbs the total round-trip error of the composition."""
    if method == "none":
        if residual is None:
            return delta, None
        return (_add_residual(delta, residual),
                tree_map(torch.zeros_like, residual))
    if method == "topk":
        return topk_sparsify(delta, k_frac, residual)
    if method == "int8":
        return int8_quantize(delta, residual)
    if method == "topk_int8":
        if residual is not None:
            delta = _add_residual(delta, residual)
        sparse, _ = topk_sparsify(delta, k_frac)
        deq, _ = int8_quantize(sparse)
        return deq, tree_map(lambda d, s: d - s, delta, deq)
    raise ValueError(
        f"unknown compression method {method!r}; available: {METHODS}")


def compression_ratio(method: str, k_frac: float = 0.01,
                      weight_bits: int = 32, index_bits: int = 32) -> float:
    """s^UT multiplier against a dense fp32 upload, clamped to <= 1.0 with
    a warning (top-k sends values and indices, so a large ``k_frac`` or
    wide ``index_bits`` would price a "compressed" upload above dense)."""
    if method not in METHODS:
        raise ValueError(
            f"unknown compression method {method!r}; available: {METHODS}")
    if method != "none" and "topk" in method and not 0.0 < k_frac <= 1.0:
        raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")
    if method == "none":
        return 1.0
    if method == "int8":
        ratio = 8.0 / weight_bits
    elif method == "topk":
        ratio = k_frac * (weight_bits + index_bits) / weight_bits
    else:  # topk_int8
        ratio = k_frac * (8.0 + index_bits) / weight_bits
    if ratio > 1.0:
        warnings.warn(
            f"compression_ratio({method!r}, k_frac={k_frac}, "
            f"index_bits={index_bits}) = {ratio:.3f} exceeds dense; "
            f"clamping s^UT multiplier to 1.0 (send dense instead)",
            stacklevel=2)
        return 1.0
    return float(ratio)
