"""Elastic scaling.

Two elasticity mechanisms mirror each other across the stack:

  * FL layer (the paper's own): the period structure re-solves the bandwidth
    allocation whenever the active service set changes -- services join or
    leave without disturbing survivors (``repro_torch.fl.simulator``).
  * Rank layer: when nodes fail or join, ``remesh`` re-factors the
    surviving rank count into a (data, model) mesh, shrinking model
    parallelism only when forced, since moving tensor-parallel shards
    moves more bytes than data-parallel ones.

Moving a checkpointed parameter tree onto the new mesh (the JAX package's
``reshard``) needs the per-architecture sharding rules, which this package
does not have yet.
"""
from __future__ import annotations

from repro_torch.launch.mesh import make_elastic_mesh


def remesh(n_ranks: int, prefer_model_parallel: int = 16):
    """The (data, model) mesh over ``n_ranks`` (the world size)."""
    return make_elastic_mesh(n_ranks, prefer_model_parallel)


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
