"""Whole-market clearing in ONE launch: the ``market_clear`` kernel, and
the auction's (N, M) demand grid: the ``mbdf_demand`` kernel.

The complete safeguarded-Newton dual solve of
``disba.solve_lambda_newton_warm``: bracket top max_n p_max, warm or cold
seed, ``iters`` trips each reducing sum demand and sum slope over every row
(bracket fold, Newton step, midpoint fallback), final demand at
``inner_iters``, projection onto sum b = B, and the Eq. 7 frequency of every
row.  The CUDA kernel is ``csrc/market_clear.cu``, a cooperative launch
that folds every trip's sums across blocks through mailboxes;
``market_clear_plain`` repeats its arithmetic in PyTorch ops.  Both
kernels give each row (B3) or (row, price) pair (B4) a group of L lanes
with R clients a lane, (L, R) chosen from K in C (``csrc/rows.cuh``
``lane_group``).

``mbdf_demand`` evaluates the modified bandwidth demand d_n(p_m) of every
service row at every price of its (ascending) bid grid: per (row, price) a
bisection of q(f) = [(1 - a) + a / (1 + f)] * f*'(b) = p on
[0, F_CEIL / max t^C], the opt-out at p >= p_max, and the Eq. 7 bandwidth
at the root.  The CUDA kernel is ``csrc/mbdf_demand.cu``;
``mbdf_demand_plain`` repeats its arithmetic in PyTorch ops.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dual_demand import (F_CEIL, NEG_INF, TINY,
                                             demand_slope_plain)

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
    fn.argtypes = ([_c_void_p] * 2 + [_c_float] + [_c_void_p] * 6
                   + [_c_int, ctypes.c_uint] + [_c_int] * 6 + [_c_void_p])
    fn.restype = _c_int
    grid = lib.market_clear_max_grid
    grid.argtypes = [_c_int] + [ctypes.POINTER(_c_int)] * 2
    grid.restype = _c_int
    return fn, grid


@functools.cache
def grid_limits(k: int, device_index: int) -> tuple[int, int, int, int]:
    """(most co-resident blocks of the kernel for K clients, SMs, L, R) on
    one device: the cooperative launch's largest grid, the one-block-per-SM
    cap, and the kernel's lane group.  Queried once per (K, device), not on
    every launch."""
    lanes, regs = _c_int(), _c_int()
    with torch.cuda.device(device_index):
        grid = _lib()[1](k, ctypes.byref(lanes), ctypes.byref(regs))
    if grid <= 0:
        raise RuntimeError(f"market_clear occupancy query failed ({grid})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return grid, sms, lanes.value, regs.value


class _Mailboxes:
    """Per device: the kernel's mailbox slots (2 x cap (demand, slope)
    partials and 2 x cap tags, zeroed once) and the next launch's first
    tag.  Tags only grow, so no slot ever holds a tag a later launch waits
    for; on wrap-around the tags are zeroed again.  One stream at a time,
    like decode_attention's counters, and no graph capture: a replayed
    launch would reuse its tags, which its first run left in the slots."""

    def __init__(self):
        self.slots: dict[int, tuple[torch.Tensor, int]] = {}
        self.next_tag: dict[int, int] = {}

    def take(self, device: torch.device, cap: int, folds: int):
        idx = device.index
        buf, have = self.slots.get(idx, (None, 0))
        if have < cap:
            # 2 cap float2 partials, then 2 cap uint32 tags
            buf = torch.zeros((6 * cap,), dtype=torch.int32, device=device)
            self.slots[idx] = (buf, cap)
            have = cap
        tag = self.next_tag.get(idx, 1)
        if tag + folds >= 1 << 32:
            buf[4 * have:].zero_()
            tag = 1
        self.next_tag[idx] = tag + folds
        return buf.data_ptr(), buf.data_ptr() + 16 * have, have, tag


_MAILBOXES = _Mailboxes()


def market_clear_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                      b_total: float, lam_prev: torch.Tensor, *,
                      iters: int = 6, inner_iters: int = 48,
                      newton_inner_iters: int = 24
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cooperative launch on the current stream, which must not be
    capturing a graph (``_Mailboxes``).  ``lam_prev`` is a 0-d float32
    tensor on the same device; inputs must already be validated
    (``ops.market_clear`` does it)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("market_clear: its mailbox tags are taken on the "
                           "host at each launch, so it cannot be captured "
                           "in a CUDA graph")
    n, k = alpha.shape
    dev = alpha.device
    most, sms, lanes, _ = grid_limits(k, dev.index)
    # at most one block per SM (and 256, the slots a lane polls), and at
    # least 4 busy warps in each
    warps = -(-n * lanes // 32)
    grid = max(1, min(most, sms, 256, -(-warps // 4)))
    part, tags, cap, tag = _MAILBOXES.take(dev, sms, iters + 2)
    out = torch.empty((2 * n + 1,), dtype=torch.float32, device=dev)
    b, f, lam = out[:n], out[n:2 * n], out[2 * n]
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lib()[0](alpha.data_ptr(), t_comp.data_ptr(), float(b_total),
                       lam_prev.data_ptr(), b.data_ptr(), f.data_ptr(),
                       lam.data_ptr(), part, tags, cap, tag, n, k, iters,
                       inner_iters, newton_inner_iters, grid, stream)
    _build.check(status, "market_clear")
    return b, f, lam


# ---------------------------------------------------------------------------
# The auction's (N, M) modified-demand grid.
# ---------------------------------------------------------------------------

def mbdf_demand_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                      prices: torch.Tensor, alpha_fair: float,
                      iters: int = 48) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> demands (N, M).

    A Python scalar over a tensor is a reciprocal and a product in PyTorch,
    so the true divisions of the kernel (and of the TPU kernel) divide a
    filled tensor instead."""
    valid = alpha > 0.0
    asum = torch.sum(alpha, dim=1, keepdim=True)                  # (N, 1)
    tcmax = torch.amax(torch.where(valid, t_comp, NEG_INF), dim=1, keepdim=True)
    active = asum > 0.0
    f_hi = torch.where(active, torch.full_like(tcmax, F_CEIL)
                       / torch.clamp(tcmax, min=TINY), 0.0)
    a_fair = torch.full_like(prices, alpha_fair)
    a3, t3 = alpha[:, None, :], t_comp[:, None, :]                # (N, 1, K)
    lo = torch.zeros_like(prices)
    hi = torch.broadcast_to(f_hi, prices.shape)
    for _ in range(iters):
        f = 0.5 * (lo + hi)
        one_m = torch.clamp(1.0 - t3 * f[:, :, None], min=TINY)
        s = torch.sum(a3 / (one_m * one_m), dim=2)
        q = ((1.0 - alpha_fair) + a_fair / (1.0 + f)) \
            * (1.0 / torch.clamp(s, min=TINY))
        go_right = (q - prices) > 0.0
        lo, hi = torch.where(go_right, f, lo), torch.where(go_right, hi, f)
    f = 0.5 * (lo + hi)
    p_max = torch.where(active, 1.0 / torch.clamp(asum, min=TINY), 0.0)
    f = torch.where(prices >= p_max, 0.0, f)
    one_m = torch.clamp(1.0 - t3 * f[:, :, None], min=TINY)
    return torch.sum(a3 * f[:, :, None] / one_m, dim=2)


@functools.cache
def _mbdf_lib():
    fn = _build.library("mbdf_demand").mbdf_demand_launch
    fn.argtypes = ([_c_void_p] * 4 + [_c_int] * 3 + [_c_float] * 2
                   + [_c_int, _c_void_p])
    fn.restype = _c_int
    return fn


def mbdf_demand_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                     prices: torch.Tensor, alpha_fair: float,
                     iters: int = 48) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Inputs must already be
    validated (``ops.mbdf_demand`` does it)."""
    n, k = alpha.shape
    m = prices.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=alpha.device)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    status = _mbdf_lib()(alpha.data_ptr(), t_comp.data_ptr(),
                         prices.data_ptr(), out.data_ptr(), n, k, m,
                         1.0 - alpha_fair, alpha_fair, iters, stream)
    _build.check(status, "mbdf_demand")
    return out
