"""Fused dual-demand evaluation: the ``dual_demand`` kernel, one launch per
DISBA dual iteration.

For every service row at price lam, bisect the Eq. 14 stationarity
condition (1 + f) * sum_k alpha_k / (1 - t^C_k f)^2 = 1 / lam on
[0, F_CEIL / max t^C], opt out (f = 0) at lam >= p_max = 1/sum alpha, and
emit the demand b = sum alpha f / (1 - t^C f) together with its Lemma 1 /
Eqns. 9-10 closed-form slope db/dlam.  A row's clients are the slots its
mask marks (``bisect_alloc``'s convention).  The CUDA kernel is
``csrc/dual_demand.cu`` (row body ``demand_slope_group`` in
``csrc/rows.cuh``, shared with ``market_clear``); ``dual_demand_plain``
repeats its arithmetic in PyTorch.  The kernel picks its speculation depth
from N, K and the card's SM count at launch (``rows.cuh`` ``plan``, the
rule B1 follows too).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _bisect, _build

NEG_INF = -1e30
TINY = 1e-30
F_CEIL = 1.0 - 1e-6  # stay strictly inside the 1 - tC*f > 0 region (Eq. 14)

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def masked(alpha: torch.Tensor, t_comp: torch.Tensor, mask: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, t^C) with 0 outside the mask, as the kernels load a row."""
    return torch.where(mask, alpha, 0.0), torch.where(mask, t_comp, 0.0)


def demand_slope_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                       mask: torch.Tensor, lam: torch.Tensor, iters: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (demand, slope) with ``lam`` a scalar or an (N, 1) column;
    returns two (N, 1) columns.  The body ``market_clear_plain`` shares;
    ``alpha`` and ``t_comp`` are already ``masked``."""
    asum = torch.sum(alpha, dim=1, keepdim=True)
    tcmax = torch.amax(torch.where(mask, t_comp, NEG_INF), dim=1, keepdim=True)
    active = asum > 0.0
    f_hi = torch.where(active, F_CEIL / torch.clamp(tcmax, min=TINY), 0.0)
    target = 1.0 / torch.clamp(lam, min=TINY)

    def go_right(f):
        one_m = torch.clamp(1.0 - t_comp * f, min=TINY)
        lhs = (1.0 + f) * torch.sum(alpha / (one_m * one_m), dim=1, keepdim=True)
        return (target - lhs) > 0.0

    lo, hi = _bisect.bisect_plain(torch.zeros_like(f_hi), f_hi, iters,
                                  go_right)
    f = 0.5 * (lo + hi)

    p_max = torch.where(active, 1.0 / torch.clamp(asum, min=TINY), 0.0)
    f = torch.where(lam >= p_max, 0.0, f)

    one_m = torch.clamp(1.0 - t_comp * f, min=TINY)
    s2 = torch.sum(alpha / (one_m * one_m), dim=1, keepdim=True)
    s3 = torch.sum(alpha * t_comp / (one_m * one_m * one_m), dim=1, keepdim=True)
    b = torch.sum(alpha * f / one_m, dim=1, keepdim=True)

    fp = 1.0 / torch.clamp(s2, min=TINY)
    s2c = torch.clamp(s2, min=TINY)
    fpp = -2.0 * s3 / (s2c * s2c * s2c)
    psi_p = (fpp * (1.0 + f) / fp - fp) / ((1.0 + f) * (1.0 + f))
    slope = torch.where(f > 0.0, (1.0 / fp) / psi_p, 0.0)
    return b, slope


def dual_demand_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                      mask: torch.Tensor, lam: torch.Tensor, iters: int = 48
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (b (N,), db/dlam (N,))."""
    lam = torch.broadcast_to(lam, (alpha.shape[0],))[:, None]
    b, slope = demand_slope_plain(*masked(alpha, t_comp, mask), mask, lam,
                                  iters)
    return b[:, 0], slope[:, 0]


@functools.cache
def _lib():
    fn = _build.library("dual_demand").dual_demand_launch
    fn.argtypes = ([_c_void_p] * 4 + [_c_int] + [_c_void_p] * 2
                   + [_c_int] * 5 + [_c_void_p])
    fn.restype = _c_int
    return fn


def dual_demand_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                     mask: torch.Tensor, lam: torch.Tensor, iters: int = 48,
                     *, depth: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream.  ``lam`` is a 0-d or
    (N,) float32 tensor on the same device; inputs must already be
    validated (``ops.dual_demand`` does it).  ``depth`` as in
    ``bisect_alloc_cuda``."""
    n, k = alpha.shape
    buf = torch.empty((2 * n,), dtype=torch.float32, device=alpha.device)
    b, slope = buf[:n], buf[n:]
    lam_stride = 0 if lam.ndim == 0 else 1
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    status = _lib()(alpha.data_ptr(), t_comp.data_ptr(), mask.data_ptr(),
                    lam.data_ptr(), lam_stride, b.data_ptr(),
                    slope.data_ptr(), n, k, iters, depth,
                    _bisect.sm_count(alpha.device), stream)
    _build.check(status, "dual_demand")
    return b, slope
