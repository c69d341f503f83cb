"""Byzantine-robust aggregation: a string-keyed registry over the FedAvg
server, beside ``core.policy``'s allocation registry.

Every aggregator has the signature ``agg(deltas, weights) ->
aggregated_delta``, ``deltas`` a tree whose leaves carry a leading client
axis (C, ...) and ``weights`` (C,), zero for a dropped straggler.  All of
them are

* mask-aware: a dropped client (weight 0) never contributes, not even a
  non-finite delta, and a round with no participant returns an exactly
  zero delta;
* shape-static and free of data-dependent Python control flow, so
  ``torch.func.vmap`` maps them over services;
* attack-hardened: a participating client whose delta holds NaN or Inf is
  excluded before any reduction (the robust entries; ``fedavg`` trusts
  the weight mask alone).

Entries: ``fedavg`` (``server.fedavg_round``), ``trimmed_mean``,
``median``, ``norm_clip`` (radius ``clip_norm`` or the median participant
norm), ``krum`` and ``multi_krum`` (smallest sum of squared distances to
the m - f - 2 nearest participants; ties to the lowest index).  The robust
entries use only the participation mask (w > 0), never the weights'
magnitudes.
"""
from __future__ import annotations

import inspect
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map

# Finite-but-huge pairwise distance for invalid pairs: keeps Krum scores
# finite for every participant.
_FAR = 1e30

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_aggregator(name: str, *, trim_frac: float = 0.1,
                   clip_norm: float | None = None, byz_f: int = 1,
                   **unknown) -> Callable:
    """Build ``agg(deltas, weights)`` by registry name.  Options unused by
    an entry are ignored; unknown ones raise."""
    if unknown:
        raise ValueError(
            f"unknown aggregator options {sorted(unknown)}; "
            f"known: {sorted(KNOWN_OPTIONS)}")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown aggregator {name!r}; available: {list(available())}")
    return _REGISTRY[name](trim_frac=trim_frac, clip_norm=clip_norm,
                           byz_f=byz_f)


KNOWN_OPTIONS = frozenset(
    p for p in inspect.signature(get_aggregator).parameters
    if p not in ("name", "unknown"))


def participation(deltas, weights) -> torch.Tensor:
    """(C,) bool: clients that met the deadline (w > 0) and sent an
    entirely finite delta."""
    part = weights > 0
    for leaf in leaves(deltas):
        finite = torch.isfinite(leaf).reshape(leaf.shape[0], -1)
        part = torch.logical_and(part, torch.all(finite, dim=1))
    return part


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def _masked_sorted(leaf: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """Sort along the client axis with non-participants pushed to +inf, so
    positions 0..m-1 hold exactly the participating values."""
    vals = torch.where(_bcast(part, leaf), leaf, torch.inf)
    return torch.sort(vals, dim=0).values


def _flatten_clients(deltas) -> torch.Tensor:
    """(C, D) float32 matrix of per-client flattened deltas."""
    ls = leaves(deltas)
    c = ls[0].shape[0]
    return torch.cat([x.reshape(c, -1).to(torch.float32) for x in ls], dim=1)


def _take(srt: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d int tensor) of ``srt``."""
    return torch.index_select(srt, 0, i.reshape(1))[0]


@register("fedavg")
def _fedavg(**_opts):
    from repro_torch.fl import server  # circular at module load
    return server.fedavg_round


@register("trimmed_mean")
def _trimmed_mean(*, trim_frac: float, **_opts):
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")

    def agg(deltas, weights):
        part = participation(deltas, weights)
        m = torch.sum(part.to(torch.int32))
        t = torch.floor(trim_frac * m).to(torch.int32)

        def one(leaf):
            srt = _masked_sorted(leaf, part)
            pos = _bcast(torch.arange(leaf.shape[0], dtype=torch.int32,
                                      device=leaf.device), leaf)
            keep = torch.logical_and(pos >= t, pos < m - t)
            num = torch.sum(torch.where(keep, srt, 0.0), dim=0)
            cnt = torch.clamp(m - 2 * t, min=1).to(leaf.dtype)
            return torch.where(m > 0, num / cnt, torch.zeros_like(num))

        return tree_map(one, deltas)

    return agg


@register("median")
def _median(**_opts):
    def agg(deltas, weights):
        part = participation(deltas, weights)
        m = torch.sum(part.to(torch.int32))
        lo_i = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
        hi_i = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)

        def one(leaf):
            srt = _masked_sorted(leaf, part)
            med = 0.5 * (_take(srt, lo_i) + _take(srt, hi_i))
            return torch.where(m > 0, med.to(leaf.dtype),
                               torch.zeros_like(med, dtype=leaf.dtype))

        return tree_map(one, deltas)

    return agg


@register("norm_clip")
def _norm_clip(*, clip_norm: float | None, **_opts):
    if clip_norm is not None and not clip_norm > 0:
        raise ValueError(f"clip_norm must be positive or None, got {clip_norm}")
    from repro_torch.fl import server

    def agg(deltas, weights):
        part = participation(deltas, weights)
        flat = _flatten_clients(deltas)
        sq = torch.sum(torch.where(part[:, None], flat, 0.0) ** 2, dim=1)
        norms = torch.sqrt(sq)                                     # (C,)
        if clip_norm is None:
            # adaptive radius: the median participant norm
            m = torch.sum(part.to(torch.int32))
            srt = torch.sort(torch.where(part, norms, torch.inf)).values
            lo = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
            hi = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
            radius = 0.5 * (_take(srt, lo) + _take(srt, hi))
            radius = torch.where(m > 0, radius, 0.0)
        else:
            radius = torch.tensor(clip_norm, dtype=norms.dtype,
                                  device=norms.device)
        factor = torch.clamp(radius / torch.clamp(norms, min=1e-30), max=1.0)
        clipped = tree_map(
            lambda leaf: leaf * _bcast(factor, leaf).to(leaf.dtype), deltas)
        return server.fedavg_round(
            clipped, torch.where(part, weights, torch.zeros_like(weights)))

    return agg


def _krum_scores(deltas, weights):
    """(part, d2): the participation mask and the (C, C) squared distances
    between participants, ``_FAR`` for every other pair."""
    part = participation(deltas, weights)
    flat = torch.where(part[:, None], _flatten_clients(deltas), 0.0)
    c = flat.shape[0]
    sq = torch.sum((flat[:, None, :] - flat[None, :, :]) ** 2, dim=-1)
    valid = torch.logical_and(part[:, None], part[None, :])
    eye = torch.eye(c, dtype=torch.bool, device=flat.device)
    valid = torch.logical_and(valid, ~eye)
    return part, torch.where(valid, sq, _FAR)


def _make_krum(byz_f: int, multi: bool):
    if byz_f < 0:
        raise ValueError(f"byz_f must be >= 0, got {byz_f}")

    def agg(deltas, weights):
        part, d2 = _krum_scores(deltas, weights)
        c = d2.shape[0]
        m = torch.sum(part.to(torch.int32))
        k = torch.minimum(torch.clamp(m - byz_f - 2, min=1),
                          torch.clamp(m - 1, min=1))
        srt = torch.sort(d2, dim=1).values
        pos = torch.arange(c, dtype=torch.int32, device=d2.device)[None, :]
        scores = torch.sum(torch.where(pos < k, srt, 0.0), dim=1)
        scores = torch.where(part, scores, torch.inf)
        if multi:
            n_sel = torch.clamp(m - byz_f, min=1, max=c)
            rank = torch.argsort(torch.argsort(scores, stable=True),
                                 stable=True)
            sel = torch.logical_and(rank < n_sel, part)
            n_sel = torch.clamp(torch.sum(sel.to(torch.int32)), min=1)

            def one(leaf):
                num = torch.sum(torch.where(_bcast(sel, leaf), leaf, 0.0),
                                dim=0)
                out = num / n_sel.to(leaf.dtype)
                return torch.where(m > 0, out, torch.zeros_like(out))
        else:
            # torch.argmin returns the first minimum: ties to the lowest index
            winner = torch.argmin(scores)

            def one(leaf):
                out = _take(leaf, winner)
                return torch.where(m > 0, out, torch.zeros_like(out))

        return tree_map(one, deltas)

    return agg


@register("krum")
def _krum(*, byz_f: int, **_opts):
    return _make_krum(byz_f, multi=False)


@register("multi_krum")
def _multi_krum(*, byz_f: int, **_opts):
    return _make_krum(byz_f, multi=True)
