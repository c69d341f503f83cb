"""Collectives over the named axes of a ``launch.mesh.Mesh``.

Every rank calls these with its own local tensor (SPMD, the body of the
JAX package's ``shard_map``).  An axis of size 1 without a process group
is the identity, as a JAX collective over a size-1 axis is.

``hierarchical_psum`` decomposes a flat all-reduce into
reduce-scatter(intra-pod) -> all-reduce(cross-pod) -> all-gather(intra-pod):
at 2 pods x 256 ranks it moves 1/256th of the gradient across the slow
link instead of the whole tensor -- the standard multi-pod gradient
schedule.

``compressed_psum_int8`` int8-quantizes shards before the cross-pod hop
(error feedback handled by the caller via the returned residual): a 4x
wire reduction on the slowest link.

The list forms of ``all_gather`` and ``reduce_scatter`` are spelled the
same in every supported torch, and gloo takes CUDA tensors in all four
collectives used here, so ranks sharing one card can run on gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``op``: ``"sum"`` or ``"max"``) over every axis in
    ``axes``, one all-reduce per axis; ``x`` itself is left as it was."""
    out = x.clone()
    for axis in axes:
        group = mesh.group(axis)
        if group is not None:
            dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 over ``axes``, block
    index row-major in ``axes`` (the first axis slowest), as
    ``out_specs=P(axes)`` assembles them."""
    out = x.contiguous()
    for axis in reversed(tuple(axes)):
        group = mesh.group(axis)
        if group is not None:
            parts = [torch.empty_like(out) for _ in range(mesh.shape[axis])]
            dist.all_gather(parts, out, group=group)
            out = torch.cat(parts)
    return out


def reduce_scatter_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, of which this rank keeps its block
    of rows (``psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter over {axis!r} ({n} ranks) needs "
                         f"a leading dim divisible by {n}, got {x.shape[0]}")
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter(out, list(x.contiguous().chunk(n)), group=group)
    return out


def hierarchical_psum(x: torch.Tensor, intra_axis: str, inter_axis: str, *,
                      mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` over (intra, inter) via RS -> AR -> AG.
    ``x``'s leading dim must divide by the intra axis size."""
    # reduce-scatter intra-pod: each intra-rank owns one block of the sum
    scattered = reduce_scatter_rows(x, mesh, intra_axis)
    # cross-pod all-reduce on the small block only
    reduced = all_reduce(scattered, mesh, (inter_axis,))
    # all-gather intra-pod to rebuild the full tensor
    return all_gather_rows(reduced, mesh, (intra_axis,))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_int8(x: torch.Tensor, intra_axis: str, inter_axis: str,
                         *, mesh):
    """Hierarchical psum with an int8 cross-pod hop.  Returns (approx_sum,
    residual) -- the caller adds the residual into the next step's input
    (error feedback).  Intra-pod stays full precision."""
    scattered = reduce_scatter_rows(x, mesh, intra_axis)
    q, scale = _quantize_int8(scattered)
    deq = q.to(torch.float32) * scale
    residual_local = scattered - deq
    reduced = all_reduce(deq, mesh, (inter_axis,))
    full = all_gather_rows(reduced, mesh, (intra_axis,))
    residual = all_gather_rows(residual_local, mesh, (intra_axis,))
    return full, residual


def make_hierarchical_allreduce(mesh, intra_axis: str = "data",
                                inter_axis: str = "pod"):
    """f(local x) -> the sum over both axes, hierarchical, on every rank."""
    def fn(x):
        return hierarchical_psum(x, intra_axis, inter_axis, mesh=mesh)

    return fn
