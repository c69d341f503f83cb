"""Batched intra-service allocation (Eq. 7): the ``bisect_alloc`` kernel.

For every service row, 48 bisection trips on u = t - max_k t^C solve
sum_k alpha_k / (u + gap_k) = b_n, then emit the optimal round time t*_n
(1/TINY where b_n <= 0) and the water-filling split alpha_k / (u + gap_k)
renormalized to sum to b_n.  The CUDA kernel is ``csrc/bisect_alloc.cu``;
``bisect_alloc_plain`` repeats its arithmetic in PyTorch ops.

Convention: a client slot is valid iff alpha > 0 (masked slots carry
alpha = 0); the valid-masked gap is 0, and every trip clamps the
denominator at TINY.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
TINY = 1e-30

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def bisect_alloc_plain(alpha: torch.Tensor, t_comp: torch.Tensor,
                       b: torch.Tensor, iters: int = 48
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (t_star (N,), b_alloc (N, K))."""
    valid = alpha > 0.0
    b = b[:, None]
    tcmax = torch.amax(torch.where(valid, t_comp, NEG_INF), dim=1, keepdim=True)
    asum = torch.sum(alpha, dim=1, keepdim=True)
    gap = torch.where(valid, tcmax - t_comp, 0.0)
    lo = torch.zeros_like(asum)
    hi = asum / torch.clamp(b, min=TINY)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        h = torch.sum(torch.where(valid, alpha / torch.clamp(mid + gap, min=TINY),
                                  0.0), dim=1, keepdim=True) - b
        go_right = h > 0.0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    u = 0.5 * (lo + hi)
    t_star = tcmax + u
    raw = torch.where(valid, alpha / torch.clamp(u + gap, min=TINY), 0.0)
    total = torch.clamp(torch.sum(raw, dim=1, keepdim=True), min=TINY)
    b_alloc = raw * (b / total)
    t_star = torch.where(b > 0.0, t_star, 1.0 / TINY)
    return t_star[:, 0], b_alloc


@functools.cache
def _lib():
    lib = _build.library("bisect_alloc")
    fn = lib.bisect_alloc_launch
    fn.argtypes = [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p]
    fn.restype = _c_int
    return fn


def bisect_alloc_cuda(alpha: torch.Tensor, t_comp: torch.Tensor,
                      b: torch.Tensor, iters: int = 48
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream.  Inputs must already be
    validated (``ops.intra_allocate`` does it)."""
    n, k = alpha.shape
    buf = torch.empty((n * (k + 1),), dtype=torch.float32, device=alpha.device)
    t_star, b_alloc = buf[:n], buf[n:].view(n, k)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    status = _lib()(alpha.data_ptr(), t_comp.data_ptr(), b.data_ptr(),
                    t_star.data_ptr(), b_alloc.data_ptr(), n, k, iters, stream)
    _build.check(status, "bisect_alloc")
    return t_star, b_alloc
