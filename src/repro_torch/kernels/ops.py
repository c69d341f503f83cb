"""Dispatch wrappers for the allocation kernels.

The device of the tensors decides the path: a CUDA tensor launches the
hand-written kernel (and raises if it cannot), a CPU tensor takes the plain
PyTorch version beside the kernel.  There is no fallback from one to the
other and no switch to force either.  Every wrapper checks device, dtype
(float32), shape and contiguity first, and counts its kernel launches in
``LAUNCHES`` (a plain integer per kernel, bumped only where the kernel is
launched), so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bisect_alloc import bisect_alloc_cuda, bisect_alloc_plain
from repro_torch.kernels.dual_demand import dual_demand_cuda, dual_demand_plain
from repro_torch.kernels.market_clear import market_clear_cuda, market_clear_plain

KERNEL_NAMES = ("bisect_alloc", "dual_demand", "market_clear")
MAX_K = 1024  # clients per service the kernels hold in registers (32 x 32)

LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, alpha: torch.Tensor, t_comp: torch.Tensor,
             **vectors: torch.Tensor) -> bool:
    """Validate a kernel's inputs; True for the CUDA path, False for CPU."""
    if alpha.ndim != 2 or t_comp.shape != alpha.shape:
        raise ValueError(f"{name}: alpha and t_comp must share one (N, K) "
                         f"shape, got {tuple(alpha.shape)} and "
                         f"{tuple(t_comp.shape)}")
    n, k = alpha.shape
    if n < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: need N >= 1 and 1 <= K <= {MAX_K}, got "
                         f"(N, K) = ({n}, {k})")
    tensors = {"alpha": alpha, "t_comp": t_comp, **vectors}
    for key, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {x.dtype}")
        if x.device != alpha.device:
            raise ValueError(f"{name}: {key} is on {x.device}, alpha on "
                             f"{alpha.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, x in vectors.items():
        if x.ndim > 1 or (x.ndim == 1 and x.shape[0] != n):
            raise ValueError(f"{name}: {key} must be a scalar or ({n},), "
                             f"got {tuple(x.shape)}")
    if alpha.device.type == "cuda":
        return True
    if alpha.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {alpha.device}")


def intra_allocate(alpha: torch.Tensor, t_comp: torch.Tensor, b: torch.Tensor,
                   *, iters: int = 48) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7 per service -> (t* (N,), per-client split (N, K))."""
    if b.ndim != 1:
        raise ValueError(f"intra_allocate: b must be (N,), got {tuple(b.shape)}")
    if _on_cuda("intra_allocate", alpha, t_comp, b=b):
        out = bisect_alloc_cuda(alpha, t_comp, b, iters)
        LAUNCHES["bisect_alloc"] += 1
        return out
    return bisect_alloc_plain(alpha, t_comp, b, iters)


def dual_demand(alpha: torch.Tensor, t_comp: torch.Tensor, lam: torch.Tensor,
                *, iters: int = 48) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-service demand b_n(lam) and slope db_n/dlam -> ((N,), (N,)).
    ``lam`` is a 0-d or (N,) float32 tensor on the tensors' device."""
    if _on_cuda("dual_demand", alpha, t_comp, lam=lam):
        out = dual_demand_cuda(alpha, t_comp, lam, iters)
        LAUNCHES["dual_demand"] += 1
        return out
    return dual_demand_plain(alpha, t_comp, lam, iters)


def market_clear(alpha: torch.Tensor, t_comp: torch.Tensor, b_total: float,
                 lam_prev: torch.Tensor, *, iters: int = 6,
                 inner_iters: int = 48, newton_inner_iters: int = 24
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole safeguarded-Newton market clear -> (b (N,), f (N,), lam ()).
    ``lam_prev`` is a 0-d float32 tensor on the tensors' device (<= 0 seeds
    cold)."""
    if lam_prev.ndim != 0:
        raise ValueError("market_clear: lam_prev must be a 0-d tensor")
    kwargs = dict(iters=iters, inner_iters=inner_iters,
                  newton_inner_iters=newton_inner_iters)
    if _on_cuda("market_clear", alpha, t_comp, lam_prev=lam_prev):
        out = market_clear_cuda(alpha, t_comp, float(b_total), lam_prev,
                                **kwargs)
        LAUNCHES["market_clear"] += 1
        return out
    return market_clear_plain(alpha, t_comp, float(b_total), lam_prev, **kwargs)
