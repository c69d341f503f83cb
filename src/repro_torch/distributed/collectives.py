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

``relayout`` and ``sum_over`` are the differentiable pair the
expert-parallel MoE and ``api.constrain`` run on: a rank's block of a
tensor under one spec (``distributed.specs``) to its block under another,
and a sum over axes whose backward hands every rank the gradient as it
is.  Gradients are the whole program's, as a ``DTensor``'s are.

The list forms of ``all_gather`` and ``reduce_scatter`` are spelled the
same in every supported torch, and gloo takes CUDA tensors in all four
collectives used here, so ranks sharing one card can run on gloo (the
functional collectives' all-gather, which ``DTensor.redistribute`` uses,
hangs there: torch 2.11, gloo, CUDA tensors).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import specs

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


# ---------------------------------------------------------------------------
# Differentiable relayouts between specs.
# ---------------------------------------------------------------------------

def _on_dim(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (which works on dim 0) applied along ``dim``."""
    return fn(x.movedim(dim, 0)).movedim(0, dim)


def _gather(x: torch.Tensor, mesh, per_dim) -> torch.Tensor:
    for dim, axes in enumerate(per_dim):
        if axes:
            x = _on_dim(lambda y: all_gather_rows(y, mesh, axes), x, dim)
    return x


def _scatter_sum(x: torch.Tensor, mesh, per_dim) -> torch.Tensor:
    for dim, axes in enumerate(per_dim):
        for axis in axes:                       # major to minor
            x = _on_dim(lambda y: reduce_scatter_rows(y, mesh, axis), x, dim)
    return x


def _take(x: torch.Tensor, mesh, per_dim) -> torch.Tensor:
    return x[specs.local_slices(tuple(per_dim), tuple(x.shape), mesh)]


class _Relayout(torch.autograd.Function):
    """Forward: gather what the source spec splits and the target does
    not, then take this rank's block of what the target splits and the
    source does not.  Backward: sum the incoming gradient over its partial
    axes the forward did not gather, gather back what the forward took,
    and of what it gathered reduce-scatter the partial axes and take this
    rank's block of the others."""

    @staticmethod
    def forward(ctx, x, mesh, gather, take, partial):
        ctx.mesh, ctx.gather, ctx.take, ctx.partial = (mesh, gather, take,
                                                       partial)
        return _take(_gather(x, mesh, gather), mesh, take)

    @staticmethod
    def backward(ctx, g):
        mesh, partial = ctx.mesh, ctx.partial
        gathered = {ax for axes in ctx.gather for ax in axes}
        g = all_reduce(g, mesh, [ax for ax in partial if ax not in gathered])
        g = _scatter_sum(_gather(g, mesh, ctx.take), mesh, [
            axes if set(axes) <= set(partial) else () for axes in ctx.gather])
        g = _take(g, mesh, [() if set(axes) <= set(partial) else axes
                            for axes in ctx.gather])
        return g, None, None, None, None


def relayout(x: torch.Tensor, mesh, src, dst, *,
             grad_partial: tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's block of a tensor under spec ``dst``, from its block
    ``x`` under spec ``src`` (all ``None``: the whole tensor, the same on
    every rank).  A dim may change from split to whole or back, not from
    one split to another.  The gradient arriving at the result is a
    partial sum over the axes ``grad_partial`` (whose ranks each add a
    share; none that ``dst`` splits), and otherwise the whole program's;
    the gradient returned for ``x`` is its block of the whole gradient
    under ``src``."""
    src, dst = tuple(src), tuple(dst)
    partial = tuple(grad_partial)
    gather, take = [], []
    for dim in range(x.dim()):
        a = specs.as_axes(src[dim] if dim < len(src) else None)
        b = specs.as_axes(dst[dim] if dim < len(dst) else None)
        if a and b and a != b:
            raise ValueError(f"dim {dim} split over {a} cannot be split "
                             f"over {b}: relayout through the whole dim")
        if b == () and 0 < len(set(a) & set(partial)) < len(a):
            raise ValueError(f"dim {dim}: the gradient is partial over "
                             f"some of its axes {a}, not all")
        gather.append(() if b else a)
        take.append(() if a else b)
    if set(partial) & {ax for entry in dst for ax in specs.as_axes(entry)}:
        raise ValueError(f"relayout {src} -> {dst}: the gradient cannot be "
                         f"partial over an axis that splits the result "
                         f"({partial})")
    return _Relayout.apply(x, mesh, tuple(gather), tuple(take), partial)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The ranks' ``x`` summed over ``axes`` (one all-reduce per axis).
    The sum is the same on every rank of those axes, and its gradient, on
    every rank the whole one, passes to each ``x`` as it is."""
    return _SumOver.apply(x, mesh, tuple(axes))
