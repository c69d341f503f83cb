"""Specs: how a tensor's dims lie over the named axes of a
``launch.mesh.Mesh``, and this rank's block under one.

A spec is a tuple over a tensor's dims, as ``jax.sharding.PartitionSpec``:
``None`` (whole on every rank), an axis name, or a tuple of axis names,
the dim split over them major to minor.  The sharding rules
(``distributed.sharding``) produce specs; the collectives
(``collectives.relayout``) and the mesh context (``api.constrain``) move
blocks between them; a ``DTensor`` carries one as its placements.
"""
from __future__ import annotations

import math

import torch

Spec = tuple


def as_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` over ``mesh``'s axes, one per
    axis in the mesh's order: ``Shard(dim)`` where the spec puts the axis
    on ``dim``, ``Replicate()`` otherwise.  Two axes on one dim must come
    in the mesh's order: DTensor splits a dim over its mesh dims left to
    right, JAX over a spec's tuple major to minor."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        axes = as_axes(entry)
        where = [mesh.axis_names.index(ax) for ax in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in the mesh's order {mesh.axis_names}")
        for i in where:
            out[i] = Shard(dim)
    return tuple(out)


def spec_of(x, mesh) -> Spec:
    """The spec of a ``DTensor`` over ``mesh``'s ``DeviceMesh`` (the
    inverse of ``placements``); a pending sum (``Partial``) raises."""
    spec: list = [()] * x.dim()
    for axis, placement in zip(mesh.axis_names, x.placements):
        if placement.is_partial():
            raise ValueError(f"{x.placements}: a pending sum over {axis!r} "
                             f"has no spec")
        if placement.is_shard():
            spec[placement.dim] += (axis,)
    return tuple(None if not axes else axes[0] if len(axes) == 1 else axes
                 for axes in spec)


def local_slices(spec: Spec, shape: tuple[int, ...], mesh) -> tuple:
    """The index of this rank's block of a tensor of ``shape`` under
    ``spec``: along a dim split over axes (a1, a2, ...), block number
    row-major in the rank's coordinates (a1 slowest), as JAX's
    ``NamedSharding(...).devices_indices_map`` lays it out."""
    out = []
    for dim, size in enumerate(shape):
        axes = as_axes(spec[dim]) if dim < len(spec) else ()
        block = 0
        for ax in axes:
            block = block * mesh.shape[ax] + mesh.coordinate(ax)
        n = math.prod(mesh.shape[ax] for ax in axes)
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split over "
                             f"{axes} ({n} ranks)")
        out.append(slice(block * (size // n), (block + 1) * (size // n)))
    return tuple(out)


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for size in reversed(tuple(shape)):
        stride.append(acc)
        acc *= size
    return tuple(reversed(stride))


def as_dtensor(local: torch.Tensor, spec: Spec, shape, mesh):
    """``local``, this rank's block under ``spec`` of a tensor of ``shape``,
    as a ``DTensor`` over ``mesh`` (differentiable; no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh.device_mesh,
                              placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def place(full, spec: Spec, mesh):
    """``full`` (the whole tensor, the same on every rank) as a ``DTensor``
    holding this rank's block under ``spec`` -- a copy where the spec
    shards it, so ``full`` can be freed.  No collective runs."""
    local = full[local_slices(spec, tuple(full.shape), mesh)]
    if any(as_axes(entry) for entry in spec):
        local = local.clone(memory_format=torch.contiguous_format)
    return as_dtensor(local, spec, full.shape, mesh)
