"""Whole-market clearing in ONE launch: the ``market_clear`` kernel.

The complete safeguarded-Newton dual solve of
``disba.solve_lambda_newton_warm``: bracket top max_n p_max, warm or cold
seed, ``iters`` trips each reducing sum demand and sum slope over every row
(bracket fold, Newton step, midpoint fallback), final demand at
``inner_iters``, projection onto sum b = B, and the Eq. 7 frequency of every
row.  The CUDA kernel is ``csrc/market_clear.cu``, a cooperative launch
with one grid-wide barrier per trip; ``market_clear_plain`` repeats its
arithmetic in PyTorch ops.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dual_demand import NEG_INF, TINY, demand_slope_plain

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def freq_plain(alpha: torch.Tensor, t_comp: torch.Tensor, b: torch.Tensor,
               iters: int) -> torch.Tensor:
    """Eq. 7 round time -> frequency per row at bandwidth b (N, 1) -> (N, 1).
    The gap is masked to 1.0 (not 0 as in ``bisect_alloc``)."""
    valid = alpha > 0.0
    asum = torch.sum(alpha, dim=1, keepdim=True)
    tcmax = torch.amax(torch.where(valid, t_comp, NEG_INF), dim=1, keepdim=True)
    gap = torch.where(valid, tcmax - t_comp, 1.0)
    lo = torch.zeros_like(asum)
    hi = asum / torch.clamp(b, min=TINY)
    for _ in range(iters):
        u = 0.5 * (lo + hi)
        val = torch.sum(alpha / (u + gap), dim=1, keepdim=True) - b
        go_right = val > 0.0
        lo, hi = torch.where(go_right, u, lo), torch.where(go_right, hi, u)
    t_star = tcmax + 0.5 * (lo + hi)
    return torch.where(b > 0.0, 1.0 / t_star, 0.0)


def market_clear_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                       b_total: float, lam_prev: torch.Tensor, *,
                       iters: int = 6, inner_iters: int = 48,
                       newton_inner_iters: int = 24
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (b (N,), f (N,), lam ())."""
    asum = torch.sum(alpha, dim=1)
    p = torch.where(asum > 0.0, 1.0 / torch.clamp(asum, min=TINY), 0.0)
    lam_hi0 = torch.amax(p)
    lam_prev = torch.as_tensor(lam_prev, dtype=torch.float32,
                               device=alpha.device)
    warm_ok = torch.logical_and(lam_prev > 0.0, lam_prev < lam_hi0)
    lam = torch.where(warm_ok, lam_prev, 0.5 * lam_hi0)
    lo, hi = torch.zeros_like(lam_hi0), lam_hi0
    for _ in range(iters):
        b_t, s_t = demand_slope_plain(alpha, t_comp, lam, newton_inner_iters)
        resid = torch.sum(b_t) - b_total
        slope = torch.sum(s_t)
        lo = torch.where(resid > 0, lam, lo)
        hi = torch.where(resid > 0, hi, lam)
        step = resid / torch.where(torch.abs(slope) > TINY, slope, -TINY)
        lam_newton = lam - step
        in_bracket = torch.logical_and(lam_newton >= lo, lam_newton <= hi)
        lam = torch.where(in_bracket, lam_newton, 0.5 * (lo + hi))
    b, _ = demand_slope_plain(alpha, t_comp, lam, inner_iters)
    b = b * (b_total / torch.clamp(torch.sum(b), min=TINY))
    f = freq_plain(alpha, t_comp, b, inner_iters)
    return b[:, 0], f[:, 0], lam


@functools.cache
def _lib():
    lib = _build.library("market_clear")
    fn = lib.market_clear_launch
    fn.argtypes = ([_c_void_p] * 2 + [_c_float] + [_c_void_p] * 5
                   + [_c_int] * 6 + [_c_void_p])
    fn.restype = _c_int
    grid = lib.market_clear_max_grid
    grid.argtypes = [_c_int]
    grid.restype = _c_int
    return fn, grid


@functools.cache
def max_grid(k: int, device_index: int) -> int:
    """The most co-resident blocks of the kernel for K clients on one
    device: the cooperative launch's largest grid.  Queried once per
    (K, device), not on every launch."""
    with torch.cuda.device(device_index):
        grid = _lib()[1](k)
    if grid <= 0:
        raise RuntimeError(f"market_clear occupancy query failed ({grid})")
    return grid


def market_clear_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                      b_total: float, lam_prev: torch.Tensor, *,
                      iters: int = 6, inner_iters: int = 48,
                      newton_inner_iters: int = 24
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cooperative launch on the current stream.  ``lam_prev`` is a 0-d
    float32 tensor on the same device; inputs must already be validated
    (``ops.market_clear`` does it)."""
    n, k = alpha.shape
    dev = alpha.device
    grid = max_grid(k, dev.index)
    # One allocation: b, f, lam, then two double-buffered (demand, slope)
    # partials per co-resident block of scratch.
    buf = torch.empty((2 * n + 1 + 4 * grid,), dtype=torch.float32, device=dev)
    b, f, lam = buf[:n], buf[n:2 * n], buf[2 * n]
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lib()[0](alpha.data_ptr(), t_comp.data_ptr(), float(b_total),
                       lam_prev.data_ptr(), b.data_ptr(), f.data_ptr(),
                       lam.data_ptr(), buf[2 * n + 1:].data_ptr(), n, k, iters,
                       inner_iters, newton_inner_iters, grid, stream)
    _build.check(status, "market_clear")
    return b, f, lam
