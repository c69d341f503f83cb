"""The port's allocation kernels: plain versions against the JAX Pallas
kernels, dispatch by device, and (on a card) CUDA kernels against their
plain versions.

On the CPU every wrapper in ``repro_torch.kernels.ops`` takes the kernel's
plain PyTorch version; these tests hold those against the TPU kernels run in
Pallas interpret mode, on ``tests/test_tile_edges.py``'s shape matrix (N not
a multiple of the TPU row tile, K not a multiple of 128, an all-inactive
row) and ``tests/test_market_clear.py``'s seeds.  Tolerances are the JAX
package's kernel-vs-``ref.py`` ones.

The kernel-vs-plain cases need a CUDA card; they decide at set-up time and
skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disba as j_disba
from repro.core import types as j_types
from repro.kernels.bisect_alloc import bisect_alloc as j_bisect_alloc
from repro.kernels.dual_demand import dual_demand as j_dual_demand
from repro.kernels.market_clear import market_clear as j_market_clear
from repro_torch.kernels import ops
from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
from repro_torch.kernels.dual_demand import dual_demand_plain
from repro_torch.kernels.market_clear import market_clear_plain

B = 10.0
EDGE_SHAPES = [(5, 13), (9, 130), (13, 100), (21, 257)]

# The condition is a string, so pytest evaluates it when each test is set
# up, never while the module is imported.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _edge_arrays(seed, n, k, min_clients=1):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.01, 0.3, size=(n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, size=(n, k)).astype(np.float32)
    mask = np.zeros((n, k), dtype=bool)
    for i in range(n):
        mask[i, : rng.integers(min_clients, k + 1)] = True
    mask[rng.integers(0, n)] = False          # a fully-inactive slot
    return (np.where(mask, alpha, 0.0).astype(np.float32),
            np.where(mask, t_comp, 0.0).astype(np.float32), mask)


def _cold_lam(a, t, m):
    svc = j_types.ServiceSet(alpha=jnp.asarray(a), t_comp=jnp.asarray(t),
                             mask=jnp.asarray(m))
    return float(j_disba.solve_lambda_bisect(svc, B).lam)


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", EDGE_SHAPES)
def test_bisect_alloc_plain_matches_pallas(n, k):
    a, t, m = _edge_arrays(1, n, k)
    b = np.random.default_rng(2).uniform(0.2, 4.0, n).astype(np.float32)
    b = np.where(m.any(1), b, 0.0).astype(np.float32)
    jt, jb = j_bisect_alloc(jnp.asarray(a), jnp.asarray(t), jnp.asarray(b),
                            interpret=True)
    tt, tb = ops.intra_allocate(torch.as_tensor(a), torch.as_tensor(t),
                                torch.as_tensor(b))
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-4)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,k", EDGE_SHAPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_dual_demand_plain_matches_pallas(n, k, per_row):
    a, t, m = _edge_arrays(0, n, k)
    lam = (np.linspace(0.05, 0.5, n).astype(np.float32) if per_row
           else np.float32(0.2))
    jb, js = j_dual_demand(jnp.asarray(a), jnp.asarray(t), jnp.asarray(lam),
                           interpret=True)
    tb, ts = ops.dual_demand(torch.as_tensor(a), torch.as_tensor(t),
                             torch.as_tensor(lam))
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-3, atol=1e-4)
    assert np.all(_np(tb)[~m.any(1)] == 0.0)


@pytest.mark.parametrize("n,k,seed_scale,iters,newton_inner", [
    (9, 31, 1.03, 6, 24),    # warm: the temporal-coherence case
    (9, 31, 0.7, 6, 24),     # stale seed -> safeguarded recovery
    (9, 31, None, 6, 24),    # cold sentinel
    (9, 31, None, 12, 48),   # the cold "megakernel" coop configuration
    (21, 257, 1.03, 6, 24),  # tile edges
    (13, 100, 1.03, 6, 24),
])
def test_market_clear_plain_matches_pallas(n, k, seed_scale, iters,
                                           newton_inner):
    a, t, m = _edge_arrays(2, n, k, min_clients=2)
    lam_prev = np.float32(-1.0 if seed_scale is None
                          else _cold_lam(a, t, m) * seed_scale)
    kw = dict(iters=iters, inner_iters=48, newton_inner_iters=newton_inner)
    jb, jf, jl = j_market_clear(jnp.asarray(a), jnp.asarray(t), jnp.float32(B),
                                jnp.asarray(lam_prev), tile_n=8,
                                interpret=True, **kw)
    tb, tf, tl = ops.market_clear(torch.as_tensor(a), torch.as_tensor(t), B,
                                  torch.tensor(lam_prev), **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(tb.sum()), B, rtol=1e-5)
    inactive = ~m.any(1)
    assert np.all(_np(tb)[inactive] == 0.0) and np.all(_np(tf)[inactive] == 0.0)


def test_market_clear_all_inactive_market():
    a, t, m = _edge_arrays(5, 9, 31)
    zeros = np.zeros_like(a)
    jb, jf, jl = j_market_clear(jnp.asarray(zeros), jnp.asarray(zeros),
                                jnp.float32(B), jnp.float32(0.2), tile_n=8,
                                interpret=True)
    tb, tf, tl = ops.market_clear(torch.as_tensor(zeros), torch.as_tensor(zeros),
                                  B, torch.tensor(0.2))
    assert np.all(_np(tb) == 0.0) and np.all(_np(tf) == 0.0)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


# ---------------------------------------------------------------------------
# Dispatch: the tensor's device decides; inputs are validated.
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    ops.reset_launches()
    a, t, m = (torch.as_tensor(x) for x in _edge_arrays(3, 7, 19))
    b = torch.full((7,), 1.5)
    got = ops.intra_allocate(a, t, b)
    want = bisect_alloc_plain(a, t, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lam = torch.tensor(0.25)
    assert all(torch.equal(g, w) for g, w in
               zip(ops.dual_demand(a, t, lam), dual_demand_plain(a, t, lam)))
    got = ops.market_clear(a, t, B, torch.tensor(-1.0))
    want = market_clear_plain(a, t, B, torch.tensor(-1.0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


@pytest.mark.parametrize("bad,error", [
    ("float64", TypeError),
    ("transposed", ValueError),
    ("shape", ValueError),
    ("lam_shape", ValueError),
    ("too_many_clients", ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, error):
    a, t, _ = (torch.as_tensor(x) for x in _edge_arrays(4, 6, 6))
    lam = torch.tensor(0.2)
    if bad == "float64":
        a = a.double()
    elif bad == "transposed":
        a = a.t()
    elif bad == "shape":
        t = t[:, :5]
    elif bad == "lam_shape":
        lam = torch.full((5,), 0.2)
    else:
        a = t = torch.zeros((2, ops.MAX_K + 1))
    with pytest.raises(error):
        ops.dual_demand(a, t, lam)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (run on a card only).
# ---------------------------------------------------------------------------

def _cuda_market(n=8191, k=45):
    a, t, _ = _edge_arrays(6, n, k, min_clients=2)
    return torch.as_tensor(a).cuda(), torch.as_tensor(t).cuda()


@needs_cuda
def test_cuda_bisect_alloc_matches_plain():
    a, t = _cuda_market()
    b = torch.where(a.sum(1) > 0, 1e-3, 0.0)
    got, want = ops.intra_allocate(a, t, b), bisect_alloc_plain(a, t, b)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-4)


@needs_cuda
def test_cuda_dual_demand_matches_plain():
    a, t = _cuda_market()
    lam = torch.tensor(0.2, device="cuda")
    for g, w in zip(ops.dual_demand(a, t, lam), dual_demand_plain(a, t, lam)):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


@needs_cuda
def test_cuda_market_clear_matches_plain():
    a, t = _cuda_market()
    seed = torch.tensor(-1.0, device="cuda")
    got = ops.market_clear(a, t, B, seed, iters=12, newton_inner_iters=48)
    want = market_clear_plain(a, t, B, seed, iters=12, newton_inner_iters=48)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)
