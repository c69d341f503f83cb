"""Mesh context for in-model sharding constraints, the counterpart of
``repro.distributed.api``.

Model code is mesh-agnostic: a launcher registers the active mesh here
(``set_mesh``, per thread) and models pin critical intermediates with
``constrain(x, "batch", None, "vocab")`` using logical axis names.

torch has no GSPMD to hand a constraint to.  A rank runs its own part of
the program, and a tensor placed over the ranks is a
``torch.distributed.tensor.DTensor``: ``constrain`` moves a ``DTensor``'s
block to the spec the names resolve to (``collectives.relayout``, c10d's
list collectives, which gloo runs on the card's tensors too), and returns
a plain tensor (this rank's own values) unchanged.  With no mesh
registered (single-process runs, the unit tests) it is a no-op.
"""
from __future__ import annotations

import threading

from repro_torch.distributed import collectives, specs

_STATE = threading.local()

# logical name -> mesh axes (resolved against the registered mesh's names)
_LOGICAL = {
    "batch": ("pod", "data"),
    "seq": ("data",),       # sequence-parallel residual stream
    "model": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "expert": ("model",),
    "ffn_shard": ("pod", "data"),  # serve-2D: expert/mlp hidden dim over data
}


def set_mesh(mesh) -> None:
    """Register ``mesh`` (a ``launch.mesh.Mesh``, or None) for this
    thread."""
    _STATE.mesh = mesh


def get_mesh():
    return getattr(_STATE, "mesh", None)


def resolve(name: str | None, mesh):
    """A logical name's mesh axes present in ``mesh``: None, one axis name,
    or a tuple of them."""
    if name is None:
        return None
    axes = tuple(ax for ax in _LOGICAL[name] if ax in mesh.axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def constraint_spec(shape, names, mesh) -> specs.Spec:
    """The spec ``constrain`` pins a tensor of ``shape`` to: each dim's
    logical name resolved against ``mesh``, and left replicated where the
    dim's size does not divide the product of its axes' sizes."""
    spec = []
    for dim, name in enumerate(names):
        axes = resolve(name, mesh)
        if axes is None:
            spec.append(None)
            continue
        n = 1
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            n *= mesh.shape[ax]
        spec.append(axes if shape[dim] % n == 0 and shape[dim] >= n
                    else None)
    return tuple(spec)


def constrain(x, *names: str | None):
    """Pin ``x`` to the layout its dims' logical names resolve to; a no-op
    without a mesh.  A ``DTensor``'s block is moved to that layout (a dim
    whose size the axes' product does not divide is whole), through the
    whole dim where a dim changes from one split to another; a plain
    tensor is this rank's own and is returned as it is."""
    mesh = get_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    src = specs.spec_of(x, mesh)
    dst = constraint_spec(tuple(x.shape), names, mesh)
    if src == dst:
        return x
    mid = tuple(a if a == b else None for a, b in zip(src, dst))
    local = x.to_local()
    for a, b in ((src, mid), (mid, dst)):
        if a != b:
            local = collectives.relayout(local, mesh, a, b)
    return specs.as_dtensor(local, dst, x.shape, mesh)
