"""What B1 (``bisect_alloc``) and B2 (``dual_demand``) share on the host:
the plain versions' bisection loop, and the SM count their launches pick
a speculation depth from (``csrc/rows.cuh`` ``plan``)."""
from __future__ import annotations

import functools

import torch


def bisect_plain(lo: torch.Tensor, hi: torch.Tensor, iters: int, go_right
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` bisection trips on [lo, hi]: mid = 0.5 (lo + hi), then
    lo = mid where ``go_right(mid)``, else hi = mid.  The plain versions'
    loop; the kernels take the same trips, two at once where they
    speculate (rows.cuh)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        right = go_right(mid)
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    return lo, hi


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device | str) -> int:
    """The SM count of ``device``'s card (read once per card)."""
    device = torch.device(device)
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)
