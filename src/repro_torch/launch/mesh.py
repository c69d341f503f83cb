"""Meshes over the ranks of a ``torch.distributed`` world.

The JAX package's meshes are devices of one process; here every rank runs
the same program (SPMD), and a mesh lays the world's ranks out on named
axes.  ``Mesh`` is a small value: the axis names and sizes, plus the
``DeviceMesh`` whose process groups carry the collectives when a default
process group is up.  The names and sizes stand alone (``Mesh(names,
sizes)`` builds a mesh without ranks, for rules that only read its shape).

Every mesh is built by ``make_mesh``, which needs the product of the axis
sizes to equal the world size: a mesh cannot take fewer ranks than were
launched (launch as many as the mesh needs, ``torchrun --nproc-per-node
N``).  Without a process group the world is one rank, so single-process
callers need no ``init_process_group``; on a one-rank world an axis has
size 1 and a reduction over it is the identity.

Functions, never module-level meshes: importing this module touches no
process group.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

FLEET_AXIS = "seeds"


def world_size() -> int:
    """Ranks of the default process group, 1 when none is initialised."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks.  ``device_mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``) is None on a one-rank
    world without a process group, and for a mesh that only records a
    shape."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_mesh: object | None = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def group(self, axis: str):
        """The process group of ``axis``, or None where the axis has size 1
        and no process group is up (a reduction over it is the identity)."""
        if self.device_mesh is not None:
            return self.device_mesh.get_group(axis)
        if self.shape[axis] != 1:
            raise ValueError(
                f"mesh axis {axis!r} of size {self.shape[axis]} has no "
                f"process group: build the mesh with make_mesh on a world "
                f"of {self.size} ranks")
        return None

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)


def _device_type() -> str:
    """The device type a ``DeviceMesh`` names by default: the card under
    ``nccl``; otherwise ``cpu`` (gloo groups, which also carry the card's
    tensors in plain collectives)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_sizes, axis_names, *, device_type: str | None = None
              ) -> Mesh:
    """The one mesh-construction path: ``axis_sizes`` over ``axis_names``,
    laying ranks out row-major (rank = the last axis's index fastest).
    Raises ``ValueError`` unless the sizes multiply to the world size.
    ``device_type`` is the ``DeviceMesh``'s (default ``_device_type()``):
    a ``DTensor`` over it keeps its local tensor on that device
    (``DTensor.from_local`` moves it there), so gloo ranks that place the
    card's tensors pass ``"cuda"``."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for axes {names}")
    world = world_size()
    if math.prod(sizes) != world:
        raise ValueError(
            f"a mesh of shape {dict(zip(names, sizes))} needs "
            f"{math.prod(sizes)} ranks, the world has {world}: launch "
            f"{math.prod(sizes)} ranks (torchrun --nproc-per-node "
            f"{math.prod(sizes)})")
    if not dist.is_available() or not dist.is_initialized():
        return Mesh(names, sizes)
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(names, sizes, init_device_mesh(
        device_type or _device_type(), sizes, mesh_dim_names=names))


def flat_mesh(n_ranks: int | None = None, axis_name: str = "data") -> Mesh:
    """A one-axis mesh over the world (the role of the JAX package's
    ``compat.flat_mesh``): ``n_ranks`` must be None or the world size."""
    return make_mesh((world_size() if n_ranks is None else n_ranks,),
                     (axis_name,))


def make_fleet_mesh(n_ranks: int | None = None) -> Mesh:
    """One-axis mesh over the seed dimension for Monte-Carlo episode
    sweeps: ``fl.simulator.run_fleet`` splits its seeds over it.  The
    JAX package takes any 1 <= n <= visible devices; here ``n_ranks`` is
    the world size or None."""
    return flat_mesh(n_ranks, axis_name=FLEET_AXIS)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_elastic_mesh(n_ranks: int, model_parallel: int = 16) -> Mesh:
    """Factor the ranks that survive a failure into (data, model),
    halving model parallelism until it divides them
    (``repro_torch.distributed.elastic``)."""
    while model_parallel > 1 and n_ranks % model_parallel != 0:
        model_parallel //= 2
    return make_mesh((n_ranks // model_parallel, model_parallel),
                     ("data", "model"))
