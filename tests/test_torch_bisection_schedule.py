"""The bisection schedule of the port's B1 and B2 kernels, rendered in
PyTorch on the CPU and held bit for bit to the plain versions.

Where the CUDA kernels speculate (``csrc/rows.cuh`` ``bisect``) they take
two bisection trips at once: lane groups evaluate the round's midpoint
and both halves' midpoints, and the first decision picks which of the
other two is the second trip's.  ``speculative_bisect`` renders that
schedule with the kernels' expressions; swapped in for the plain
versions' loop (``_bisect.bisect_plain``) it must leave every output
bitwise unchanged.  The kernels themselves are held to these plain
versions on a card (test_torch_kernels and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _bisect
from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
from repro_torch.kernels.dual_demand import demand_slope_plain

PLAIN_LOOP = _bisect.bisect_plain


def speculative_bisect(lo, hi, iters, go_right):
    """The kernels' speculative schedule as a drop-in for ``bisect_plain``:
    rounds of two trips, then a single trip for an odd count."""
    it = 0
    while it + 2 <= iters:
        m = 0.5 * (lo + hi)
        root = go_right(m)                        # groups 0 and 3
        left = go_right(0.5 * (lo + m))           # group 1
        right_half = go_right(0.5 * (m + hi))     # group 2
        lo, hi = torch.where(root, m, lo), torch.where(root, hi, m)
        m2 = 0.5 * (lo + hi)
        second = torch.where(root, right_half, left)
        lo, hi = torch.where(second, m2, lo), torch.where(second, hi, m2)
        it += 2
    return PLAIN_LOOP(lo, hi, iters - it, go_right)


def _rows(k, seed=0, n=13):
    """``_edge_arrays``-style rows: ragged client counts, row 3 inactive,
    budgets U(0.2, 4) with row 6's 0, prices p_max x U(0.1, 0.9) with row
    9's past p_max (the opt-out)."""
    rng = np.random.default_rng([seed, k])
    alpha = rng.uniform(0.01, 0.3, (n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, (n, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < rng.integers(1, k + 1, (n, 1))
    mask[3] = False
    keep = torch.from_numpy(mask)
    alpha = torch.from_numpy(np.where(mask, alpha, 0.0).astype(np.float32))
    t_comp = torch.from_numpy(np.where(mask, t_comp, 0.0).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.2, 4.0, n).astype(np.float32))
    b[3] = b[6] = 0.0
    asum = alpha.sum(dim=1)
    p_max = torch.where(asum > 0, 1.0 / torch.clamp(asum, min=1e-30), 0.0)
    u = torch.from_numpy(rng.uniform(0.1, 0.9, n).astype(np.float32))
    u[9] = 1.15
    return alpha, t_comp, keep, b, (p_max * u)[:, None]


def _bits(*xs):
    return [x.contiguous().view(torch.int32) for x in xs]


SCHEDULE_ITERS = [24, 48, 7, 1]
SCHEDULE_K = [1, 7, 45, 64]


@pytest.mark.parametrize("iters", SCHEDULE_ITERS)
@pytest.mark.parametrize("k", SCHEDULE_K)
def test_schedule_gives_bisect_alloc_plain_bits(k, iters, monkeypatch):
    alpha, t_comp, mask, b, _ = _rows(k)
    want = bisect_alloc_plain(alpha, t_comp, mask, b, iters)
    monkeypatch.setattr(_bisect, "bisect_plain", speculative_bisect)
    got = bisect_alloc_plain(alpha, t_comp, mask, b, iters)
    for g, w in zip(_bits(*got), _bits(*want)):
        assert torch.equal(g, w)
    assert got[0][6] == 1e30 and not got[1][6].any()   # the b = 0 row
    assert not got[1][3].any()                          # the inactive row


@pytest.mark.parametrize("iters", SCHEDULE_ITERS)
@pytest.mark.parametrize("k", SCHEDULE_K)
def test_schedule_gives_demand_slope_plain_bits(k, iters, monkeypatch):
    alpha, t_comp, mask, _, lam = _rows(k, seed=1)
    want = demand_slope_plain(alpha, t_comp, mask, lam, iters)
    monkeypatch.setattr(_bisect, "bisect_plain", speculative_bisect)
    got = demand_slope_plain(alpha, t_comp, mask, lam, iters)
    for g, w in zip(_bits(*got), _bits(*want)):
        assert torch.equal(g, w)
    assert got[0][3] == 0 and got[1][3] == 0            # the inactive row
    assert got[0][9] == 0                               # opted out


@pytest.mark.parametrize("iters", [24, 48])
@pytest.mark.parametrize("row", [3, 6])
def test_rows_without_trips_skip_them_exactly(iters, row):
    """A warp skips its trips where no row needs them: B1's inactive rows
    (row 3) and rows with b = 0 (row 6), B2's inactive rows.  Such rows'
    outputs at 0 trips are the bits of the full count."""
    alpha, t_comp, mask, b, lam = _rows(45)
    full = bisect_alloc_plain(alpha, t_comp, mask, b, iters)
    none = bisect_alloc_plain(alpha, t_comp, mask, b, 0)
    for g, w in zip(_bits(full[0][row:row + 1], full[1][row]),
                    _bits(none[0][row:row + 1], none[1][row])):
        assert torch.equal(g, w)
    full = demand_slope_plain(alpha, t_comp, mask, lam, iters)
    assert float(full[0][3]) == 0.0 and float(full[1][3]) == 0.0
