"""The port's auction path against the JAX package: the plain version of
kernel B4 (``mbdf_demand``), ``core/fairness.py`` and ``core/auction.py``.

The same numpy-seeded masked sets go through both packages on the CPU.
Where the port is fed the reference's own bid book (``MultiBid``), the book
logic must agree exactly: equal sort order, equal clearing and
leave-one-out prices.  Everything computed by bisection or summation
agrees to float32 rounding: demands and allocations rtol 1e-4 / atol 1e-5
(the JAX package's own kernel-vs-reference bound,
``tests/test_market_clear.py``), frequencies rtol 1e-3 / atol 1e-5 as in
the other port tests, charges and utilities rtol 1e-4 with atol 1e-5 plus
1e-6 of the book's welfare sum_j F_j(b_j): the prefix charge is a
difference of two such sums, so its float32 residue scales with them.
Each (N, K, M) case runs at one alpha_fair, cycling through 0, 0.5, 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import auction as j_auction
from repro.core import fairness as j_fairness
from repro.core import network as j_network
from repro.core import types as j_types
from repro.kernels.market_clear import mbdf_demand as j_mbdf_demand
from repro_torch import interop
from repro_torch.core import auction, disba, fairness, policy
from repro_torch.kernels import ops
from repro_torch.kernels.market_clear import mbdf_demand_plain

B = 10.0
CPU = torch.device("cpu")
EDGE_SHAPES = [(5, 13), (9, 130), (13, 100), (21, 257)]
ALPHAS = [0.0, 0.5, 1.0]
# (N, K, M) over N in {1, 7, 33}, K in {1, 5, 45}, M in {1, 3, 5}
NKM = [(1, 1, 1), (1, 45, 5), (7, 5, 3), (7, 45, 5), (33, 1, 3),
       (33, 5, 1), (33, 45, 5)]
NKMA = [(*nkm, ALPHAS[i % 3]) for i, nkm in enumerate(NKM)]


class J:
    """The reference's auction entry points under ``jax.jit``: one compile
    per shape instead of one per operation (the values are those of the
    eager calls; only the test's time changes)."""

    bids = staticmethod(jax.jit(j_auction.uniform_truthful_bids,
                                static_argnums=(1, 2)))
    book = staticmethod(jax.jit(j_auction._sorted_book))
    clearing_price = staticmethod(jax.jit(j_auction.clearing_price))
    loo = staticmethod(jax.jit(j_auction.leave_one_out_prices))
    allocate = staticmethod(jax.jit(j_auction.allocate))
    charges = staticmethod(jax.jit(j_auction.charges, static_argnums=(4,),
                                   static_argnames=("method",)))
    pseudo_mbdf = staticmethod(jax.jit(j_auction.pseudo_mbdf,
                                       static_argnums=(2,)))
    integral = staticmethod(jax.jit(j_auction.pseudo_mmvf_integral))
    delta_bound = staticmethod(jax.jit(j_auction.delta_bound,
                                       static_argnums=(2,)))
DEMAND_TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(seed, n, k, min_clients=1, inactive=True):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.01, 0.3, size=(n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, size=(n, k)).astype(np.float32)
    mask = np.zeros((n, k), dtype=bool)
    for i in range(n):
        mask[i, : rng.integers(min_clients, k + 1)] = True
    if inactive and n > 1:
        mask[rng.integers(0, n)] = False          # a fully inactive slot
    return (np.where(mask, alpha, 0.0).astype(np.float32),
            np.where(mask, t_comp, 0.0).astype(np.float32), mask)


def _pair(seed, n, k, **kw):
    a, t, m = _arrays(seed, n, k, **kw)
    j = j_types.ServiceSet(alpha=jnp.asarray(a), t_comp=jnp.asarray(t),
                           mask=jnp.asarray(m))
    return j, interop.service_set_from_arrays(a, t, m, device=CPU)


def _bid(jbid):
    return interop.multibid_from_arrays(np.asarray(jbid.prices),
                                        np.asarray(jbid.demands), device=CPU)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **tol)


# ---------------------------------------------------------------------------
# Kernel B4: the plain version against the Pallas kernel and the grid.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha_fair", ALPHAS)
@pytest.mark.parametrize("n,k", EDGE_SHAPES)
def test_mbdf_demand_plain_matches_pallas_and_grid(n, k, alpha_fair):
    j, t = _pair(n * k, n, k)
    prices = J.bids(j, 5, alpha_fair).prices
    want_kernel = j_mbdf_demand(j.alpha, j.t_comp, prices, alpha_fair,
                                interpret=True)
    want_grid = j_fairness.mbdf_grid(j, prices, alpha_fair)
    p = torch.as_tensor(np.array(prices))
    got = ops.mbdf_demand(t.alpha, t.t_comp, t.mask, p, alpha_fair)
    _close(got, want_kernel, **DEMAND_TOL)
    _close(got, want_grid, **DEMAND_TOL)
    inactive = ~np.asarray(j.mask).any(1)
    assert np.all(got.numpy()[inactive] == 0.0)
    # non-increasing along the ascending price grid
    assert bool(torch.all(got[:, 1:] <= got[:, :-1] + 1e-5))
    for backend in fairness.MBDF_BACKENDS:
        _close(fairness.mbdf_grid(t, p, alpha_fair, backend=backend),
               want_grid, **DEMAND_TOL)


def test_mbdf_demand_wrapper_dispatch_and_checks():
    _, t = _pair(3, 6, 9)
    p = torch.rand(6, 4)
    ops.reset_launches()
    assert torch.equal(ops.mbdf_demand(t.alpha, t.t_comp, t.mask, p, 0.5),
                       mbdf_demand_plain(t.alpha, t.t_comp, t.mask, p, 0.5))
    assert ops.LAUNCHES["mbdf_demand"] == 0
    assert "mbdf_demand" in ops.KERNEL_NAMES
    for bad, error in [(p[:5], ValueError), (p.double(), TypeError),
                       (p.t().contiguous().t(), ValueError),
                       (p[:, :0], ValueError)]:
        with pytest.raises(error):
            ops.mbdf_demand(t.alpha, t.t_comp, t.mask, bad, 0.5)
    with pytest.raises(ValueError, match="mbdf backend"):
        fairness.mbdf_grid(t, p, 0.5, backend="nope")


# ---------------------------------------------------------------------------
# fairness.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,m,a", NKMA)
def test_fairness_functions_match(n, k, m, a):
    j, t = _pair(11 + n + k, n, k)
    f = np.random.default_rng(n).uniform(0.0, 3.0, n).astype(np.float32)
    tf = torch.as_tensor(f)
    _close(fairness.g_value(tf, a), j_fairness.g_value(jnp.asarray(f), a),
           rtol=1e-6, atol=1e-7)
    _close(fairness.fairness_cost(tf, a),
           j_fairness.fairness_cost(jnp.asarray(f), a), rtol=1e-5, atol=1e-7)
    _close(fairness.g_prime_at_f(t, tf, a),
           j_fairness.g_prime_at_f(j, jnp.asarray(f), a), rtol=1e-5)
    price = np.float32(0.3 / k)
    _close(fairness.mbdf(t, price, a), j_fairness.mbdf(j, price, a),
           **DEMAND_TOL)
    prices = np.array(J.bids(j, m, a).prices)
    _close(fairness.mbdf(t, prices[:, 0], a),
           j_fairness.mbdf(j, jnp.asarray(prices[:, 0]), a), **DEMAND_TOL)
    res = fairness.exact_mmcp(t, B, a)
    ref = j_fairness.exact_mmcp(j, B, a)
    _close(res.price, ref.price, rtol=1e-4)
    _close(res.b, ref.b, **DEMAND_TOL)
    _close(res.f, ref.f, rtol=1e-3, atol=1e-5)
    _close(fairness.provider_utility(t, res.b, res.price, a),
           j_fairness.provider_utility(j, ref.b, ref.price, a),
           rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# auction.py, on the reference's own bid books.
# ---------------------------------------------------------------------------

def _charge_tol(jbid, jb):
    welfare = float(np.sum(np.asarray(J.integral(
        jbid, jnp.zeros_like(jb), jb))))
    return dict(rtol=1e-4, atol=1e-5 + 1e-6 * welfare)


@pytest.mark.parametrize("n,k,m,a", NKMA)
def test_auction_book_logic_matches_exactly(n, k, m, a):
    j, t = _pair(5 * n + k, n, k)
    jbid = J.bids(j, m, a)
    bid = _bid(jbid)
    jbook, book = J.book(jbid), auction._sorted_book(bid)
    for field in ("order", "pos_desc"):
        assert np.array_equal(getattr(book, field).numpy(),
                              np.asarray(getattr(jbook, field)))
    for field in ("p_sorted", "d_sorted", "csum", "vsum"):
        assert np.array_equal(getattr(book, field).numpy(),
                              np.asarray(getattr(jbook, field))), field
    w = np.ones(n, np.float32)
    w[0] = 0.0
    for supply in (B, float(np.asarray(jbid.demands).sum()) + 1.0):
        assert (float(auction.clearing_price(bid, supply))
                == float(J.clearing_price(jbid, supply)))
        assert (float(auction.clearing_price(bid, supply,
                                             weights=torch.as_tensor(w)))
                == float(J.clearing_price(jbid, supply,
                                                  weights=jnp.asarray(w))))
        assert np.array_equal(
            auction.leave_one_out_prices(bid, supply).numpy(),
            np.asarray(J.loo(jbid, supply)))
        b, zeta = auction.allocate(bid, supply)
        jb, jzeta = J.allocate(jbid, supply)
        assert float(zeta) == float(jzeta)
        _close(b, jb, **DEMAND_TOL)
    tb = torch.as_tensor(np.array(jb))
    for method in auction.CHARGE_METHODS:
        _close(auction.charges(t, bid, tb, supply, a, method=method),
               J.charges(j, jbid, jb, supply, a, method=method),
               **_charge_tol(jbid, jb))


@pytest.mark.parametrize("n,k,m,a", NKMA)
def test_auction_entry_points_match(n, k, m, a):
    j, t = _pair(7 * n + k, n, k)
    jbid = J.bids(j, m, a)
    for backend in ("reference", "pallas"):
        bid = auction.uniform_truthful_bids(t, m, a, backend=backend)
        _close(bid.prices, jbid.prices, rtol=1e-6)
        _close(bid.demands, jbid.demands, **DEMAND_TOL)
    bid = _bid(jbid)
    for p in (0.0, float(np.asarray(jbid.prices).max()),
              float(np.median(np.asarray(jbid.prices)))):
        for side in ("left", "right"):
            assert np.array_equal(
                auction.pseudo_mbdf(bid, p, side).numpy(),
                np.asarray(J.pseudo_mbdf(jbid, jnp.float32(p), side)))
    lo = np.zeros(n, np.float32)
    hi = np.asarray(jbid.demands)[:, 0] * 0.7
    _close(auction.pseudo_mmvf_integral(bid, torch.as_tensor(lo),
                                        torch.as_tensor(hi)),
           J.integral(jbid, jnp.asarray(lo),
                                          jnp.asarray(hi)),
           rtol=1e-5, atol=1e-7)
    _close(auction.delta_bound(t, bid, a), J.delta_bound(j, jbid, a),
           rtol=1e-4, atol=1e-5)
    res, ref = auction.run_auction(t, B, m, a), j_auction.run_auction(j, B, m, a)
    _close(res.price, ref.price, rtol=1e-4)
    _close(res.b, ref.b, **DEMAND_TOL)
    tol = _charge_tol(J.bids(j, m, a), ref.b)
    for field in ("charges", "utilities"):
        _close(getattr(res, field), getattr(ref, field), **tol)
    _close(res.f, ref.f, rtol=1e-3, atol=1e-5)


def test_hand_example_and_tied_book():
    # tests/test_core_auction.py's hand example: two providers, supply 6
    prices = np.array([[1.0, 2.0], [1.5, 2.5]], np.float32)
    demands = np.array([[5.0, 2.0], [4.0, 1.0]], np.float32)
    jbid = j_auction.MultiBid(jnp.asarray(prices), jnp.asarray(demands))
    bid = interop.multibid_from_arrays(prices, demands, device=CPU)
    assert float(auction.clearing_price(bid, 6.0)) == 1.0
    b, zeta = auction.allocate(bid, 6.0)
    assert float(zeta) == 1.0
    _close(b, J.allocate(jbid, 6.0)[0], rtol=1e-6)
    assert abs(float(b.sum()) - 6.0) < 1e-6
    one = interop.multibid_from_arrays([[1.0, 2.0, 3.0]], [[6.0, 4.0, 1.0]],
                                       device=CPU)
    assert float(auction.pseudo_mbdf(one, 1.0, "left")[0]) == 6.0
    assert float(auction.pseudo_mbdf(one, 1.0, "right")[0]) == 4.0
    assert float(auction.pseudo_mbdf(one, 3.5)[0]) == 0.0
    assert abs(float(auction.pseudo_mmvf_integral(
        one, torch.tensor([0.5]), torch.tensor([4.5]))[0]) - 8.0) < 1e-5

    # A book with tied prices: shared price levels across providers and
    # two inactive rows bidding at price 0.
    prices = np.array([[0.1, 0.2, 0.3], [0.1, 0.2, 0.3], [0.0, 0.0, 0.0],
                       [0.2, 0.3, 0.4], [0.0, 0.0, 0.0]], np.float32)
    demands = np.array([[3.0, 2.0, 1.0], [4.0, 2.0, 0.5], [0.0, 0.0, 0.0],
                        [5.0, 3.0, 1.0], [0.0, 0.0, 0.0]], np.float32)
    jbid = j_auction.MultiBid(jnp.asarray(prices), jnp.asarray(demands))
    bid = interop.multibid_from_arrays(prices, demands, device=CPU)
    jbook, book = J.book(jbid), auction._sorted_book(bid)
    assert np.array_equal(book.order.numpy(), np.asarray(jbook.order))
    assert np.array_equal(book.pos_desc.numpy(), np.asarray(jbook.pos_desc))
    for supply in (1.0, 4.0, 6.5, 9.0, 12.0, 30.0):
        assert (float(auction.clearing_price(bid, supply))
                == float(J.clearing_price(jbid, supply)))
        assert np.array_equal(
            auction.leave_one_out_prices(bid, supply).numpy(),
            np.asarray(J.loo(jbid, supply)))
        b, _ = auction.allocate(bid, supply)
        _close(b, J.allocate(jbid, supply)[0], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Properties of tests/test_core_auction.py, on the port.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table1():
    svc, _ = j_network.table1_service_set(jax.random.key(0))
    return interop.service_set_from_arrays(
        np.asarray(svc.alpha), np.asarray(svc.t_comp), np.asarray(svc.mask),
        device=CPU)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_supply_conservation_and_individual_rationality(table1, backend):
    for a in (0.0, 0.5, 1.0):
        res = auction.run_auction(table1, B, n_bids=5, alpha_fair=a,
                                  backend=backend)
        assert abs(float(res.b.sum()) - B) <= 1e-5 * B
        assert bool(torch.all(res.b >= -1e-6))
        assert bool(torch.all(res.utilities >= -1e-4))
        assert bool(torch.all(
            res.charges >= fairness.fairness_cost(res.f, a) - 1e-6))
    for seed in range(4):
        a_, t_, _ = _arrays(seed, 6, 8, min_clients=8, inactive=False)
        svc = interop.service_set_from_arrays(a_, t_, np.ones((6, 8), bool),
                                              device=CPU)
        bid = auction.uniform_truthful_bids(svc, 2 + 3 * seed, 0.5,
                                            backend=backend)
        b, _ = auction.allocate(bid, B)
        assert bool(torch.all(torch.diff(bid.prices, dim=1) > 0))
        assert bool(torch.all(torch.diff(bid.demands, dim=1) <= 1e-5))
        if float(bid.demands[:, 0].sum()) > B:
            assert abs(float(b.sum()) - B) <= 1e-4 * B


def test_alpha_one_recovers_coop(table1):
    exact = fairness.exact_mmcp(table1, B, 1.0)
    coop = disba.solve_lambda_bisect(table1, B)
    np.testing.assert_allclose(exact.b.numpy(), coop.b.numpy(), rtol=2e-2,
                               atol=1e-2)
    b, _ = policy.get_policy("selfish", alpha_fair=1.0, n_bids=40)(table1, B)
    np.testing.assert_allclose(b.numpy(), coop.b.numpy(), rtol=0.1, atol=0.1)
    deltas = [auction.delta_bound(
        table1, auction.uniform_truthful_bids(table1, m, 0.5), 0.5)
        for m in (4, 32)]
    assert bool(torch.all(deltas[1] <= 0.5 * deltas[0]))


@pytest.mark.parametrize("backend", ["reference", "pallas", "megakernel"])
def test_selfish_policy_matches_reference(backend):
    from repro.core import policy as j_policy

    j, t = _pair(21, 9, 31)
    for a in ALPHAS:
        want_b, want_f = jax.jit(j_policy.get_policy(
            "selfish", alpha_fair=a, intra_backend="reference"),
            static_argnums=(1,))(j, B)
        b, f = policy.get_policy("selfish", alpha_fair=a,
                                 intra_backend=backend)(t, B)
        _close(b, want_b, rtol=1e-3, atol=1e-4)
        _close(f, want_f, rtol=1e-3, atol=1e-5)
        inactive = ~np.asarray(j.mask).any(1)
        assert np.all(b.numpy()[inactive] == 0) and np.all(
            f.numpy()[inactive] == 0)
    # no warm variant: the stateful form wraps it with an empty carry
    pol = policy.get_stateful_policy("selfish", warm_start=True,
                                     intra_backend=backend)
    assert pol.init_state(9, CPU) == ()
    assert len(pol.step(t, B, ())) == 3
