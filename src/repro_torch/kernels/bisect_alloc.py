"""Batched intra-service allocation (Eq. 7): the ``bisect_alloc`` kernel.

For every service row, 48 bisection trips on u = t - max_k t^C solve
sum_k alpha_k / (u + gap_k) = b_n, then emit the optimal round time t*_n
(1/TINY where b_n <= 0) and the water-filling split alpha_k / (u + gap_k)
renormalized to sum to b_n.  The CUDA kernel is ``csrc/bisect_alloc.cu``
(row body ``bisect_group`` in ``csrc/rows.cuh``); ``bisect_alloc_plain``
repeats its arithmetic in PyTorch ops.  The kernel picks its speculation
depth (the trips it takes at once, with the bits of one at a time) from
N, K and the card's SM count at launch; ``bisect_alloc_plan`` reports it.

Convention: a row's clients are the slots its mask (the service set's)
marks, whatever their alpha, as in ``core/intra.py`` (the TPU kernel takes
alpha > 0 as a client's mark instead, which leaves a client with no
transmission load out of max t^C); alpha and the gap are 0 elsewhere, and
every trip clamps the denominator at TINY.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _bisect, _build

NEG_INF = -1e30
TINY = 1e-30

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def bisect_alloc_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                       mask: torch.Tensor, b: torch.Tensor, iters: int = 48
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (t_star (N,), b_alloc (N, K))."""
    alpha = torch.where(mask, alpha, 0.0)
    b = b[:, None]
    tcmax = torch.amax(torch.where(mask, t_comp, NEG_INF), dim=1, keepdim=True)
    asum = torch.sum(alpha, dim=1, keepdim=True)
    gap = torch.where(mask, tcmax - t_comp, 0.0)
    lo, hi = _bisect.bisect_plain(
        torch.zeros_like(asum), asum / torch.clamp(b, min=TINY), iters,
        lambda mid: torch.sum(alpha / torch.clamp(mid + gap, min=TINY),
                              dim=1, keepdim=True) - b > 0.0)
    u = 0.5 * (lo + hi)
    t_star = tcmax + u
    raw = alpha / torch.clamp(u + gap, min=TINY)
    total = torch.clamp(torch.sum(raw, dim=1, keepdim=True), min=TINY)
    b_alloc = raw * (b / total)
    t_star = torch.where(b > 0.0, t_star, 1.0 / TINY)
    return t_star[:, 0], b_alloc


@functools.cache
def _lib():
    lib = _build.library("bisect_alloc")
    plan, launch = lib.bisect_alloc_plan, lib.bisect_alloc_launch
    plan.argtypes = [_c_int] * 4
    launch.argtypes = [_c_void_p] * 6 + [_c_int] * 5 + [_c_void_p]
    plan.restype = launch.restype = _c_int
    return plan, launch


def bisect_alloc_plan(n: int, k: int, depth: int = 0,
                      device: torch.device | str = "cuda") -> int:
    """The speculation depth of a launch of N rows of K clients on
    ``device``'s card: the one it picks (``depth`` 0) or is given (1 or
    2).  B2 (``dual_demand``) picks by the same rule (``rows.cuh``)."""
    got = _lib()[0](n, k, depth, _bisect.sm_count(device))
    if got < 0:
        raise ValueError(f"bisect_alloc: no kernel for N = {n}, K = {k} at "
                         f"depth {depth}")
    return got


def bisect_alloc_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                      mask: torch.Tensor, b: torch.Tensor, iters: int = 48, *,
                      depth: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream.  Inputs must already be
    validated (``ops.intra_allocate`` does it).  ``depth`` 0 lets the
    launch pick its speculation depth; 1 or 2 forces one, for
    measurement."""
    n, k = alpha.shape
    buf = torch.empty((n * (k + 1),), dtype=torch.float32, device=alpha.device)
    t_star, b_alloc = buf[:n], buf[n:].view(n, k)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    status = _lib()[1](alpha.data_ptr(), t_comp.data_ptr(), mask.data_ptr(),
                       b.data_ptr(), t_star.data_ptr(), b_alloc.data_ptr(), n,
                       k, iters, depth, _bisect.sm_count(alpha.device), stream)
    _build.check(status, "bisect_alloc")
    return t_star, b_alloc
