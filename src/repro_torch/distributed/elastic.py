"""Elastic scaling.

Two elasticity mechanisms mirror each other across the stack:

  * FL layer (the paper's own): the period structure re-solves the bandwidth
    allocation whenever the active service set changes -- services join or
    leave without disturbing survivors (``repro_torch.fl.simulator``).
  * Rank layer: when nodes fail or join, ``remesh`` re-factors the
    surviving rank count into a (data, model) mesh, shrinking model
    parallelism only when forced, since moving tensor-parallel shards
    moves more bytes than data-parallel ones, and ``reshard`` places a
    checkpointed parameter tree on the new mesh with the arch's sharding
    rules.  Combined with deterministic data and step-atomic checkpoints,
    an elastic restart is a pure function of (checkpoint, new rank count).
"""
from __future__ import annotations

from typing import Any

from repro_torch.distributed import sharding, specs
from repro_torch.launch.mesh import make_elastic_mesh


def remesh(n_ranks: int, prefer_model_parallel: int = 16):
    """The (data, model) mesh over ``n_ranks`` (the world size)."""
    return make_elastic_mesh(n_ranks, prefer_model_parallel)


def reshard(cfg, params: Any, new_mesh, *, fsdp: bool | None = None,
            serve_2d: bool = False) -> Any:
    """Place an unsharded (checkpointed) parameter tree on ``new_mesh`` by
    the arch's rules (``sharding.param_shardings``, whose ``fsdp`` and
    ``serve_2d`` these are): every leaf becomes a ``DTensor`` holding this
    rank's block.  Every rank holds the same tree, as ``jax.device_put`` of
    a host tree has it, so each takes its block locally (a copy where the
    leaf is sharded: the tree can be freed) and no collective runs.  On a
    one-rank world without a process group the tree is returned as it
    is."""
    by_path = dict(sharding.spec_leaves(sharding.param_shardings(
        cfg, params, new_mesh, fsdp=fsdp, serve_2d=serve_2d)))
    if new_mesh.device_mesh is None:
        return params
    return sharding.map_with_path(
        lambda path, leaf: specs.place(leaf, by_path[path], new_mesh),
        params)


def _factor(n_ranks: int, model_parallel: int) -> dict:
    while model_parallel > 1 and n_ranks % model_parallel != 0:
        model_parallel //= 2
    return {"data": n_ranks // model_parallel, "model": model_parallel}


def plan_service_remesh(n_devices_before: int, n_devices_after: int,
                        model_parallel: int = 16) -> dict:
    """Report of what an elastic transition changes: mesh shapes and
    which parallelism axis absorbs the change.  Pure arithmetic -- safe to
    call without the ranks present."""
    before = _factor(n_devices_before, model_parallel)
    after = _factor(n_devices_after, model_parallel)
    return {
        "before": before,
        "after": after,
        "model_parallel_changed": before["model"] != after["model"],
    }
