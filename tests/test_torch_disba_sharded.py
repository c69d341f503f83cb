"""The port's ``disba.disba_sharded`` against the JAX package's.

One rank (no process group) in-process: the mirrors of
``tests/test_core_disba.py``'s sharded cases (one-device mesh, the
default mesh, masked and padded sets against the dense solve; b rtol
1e-4 / atol 1e-5) and of ``tests/test_market_clear.py``'s sharded Newton
(``"reference"`` and ``"pallas"`` against the JAX package's
``disba_sharded`` on its one-device mesh, the Pallas side in interpret
mode; b rtol 1e-3 / atol 1e-4, lam rtol 1e-3).  Eight gloo ranks
(``torch_ranks.py``, one launch for the file): bisection and Newton on a
flat mesh, a (pod, data) mesh and a mesh replicated over ``model``,
against the JAX package's dense solves at rtol 1e-3 / atol 1e-4 with
sum b = B at rtol 1e-5; a set that does not split over the ranks raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disba as j_disba
from repro.core import network as j_network
from repro.core import types as j_types
from repro_torch import interop
from repro_torch.core import disba
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from test_torch_disba import _pair
from torch_ranks import launch

B = j_network.B_TOTAL_MHZ
CPU = torch.device("cpu")
RANKS = 8
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _port(j, device=CPU):
    return interop.service_set_from_arrays(j.alpha, j.t_comp, j.mask,
                                           device=device)


def _arrays(j):
    return tuple(np.asarray(x) for x in (j.alpha, j.t_comp, j.mask))


def _pad(j, multiple: int):
    """All-masked rows appended until N divides ``multiple``."""
    extra = -j.n_services % multiple
    z = jnp.zeros((extra, j.alpha.shape[1]), j.alpha.dtype)
    return j_types.ServiceSet(
        alpha=jnp.concatenate([j.alpha, z]),
        t_comp=jnp.concatenate([j.t_comp, z]),
        mask=jnp.concatenate([j.mask, jnp.zeros(z.shape, bool)]))


@pytest.fixture(scope="module")
def table1():
    svc, _ = j_network.table1_service_set(jax.random.key(0))
    return svc


def _close(res, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(res.b), np.asarray(ref.b),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# One rank.
# ---------------------------------------------------------------------------

def test_disba_sharded_single_rank(table1):
    """A one-rank mesh: the dense reference, and the JAX package's
    ``disba_sharded`` on its one-device mesh."""
    mesh = mesh_lib.make_mesh((1,), ("data",))
    res = disba.disba_sharded(mesh, _port(table1), B, axis_names=("data",))
    _close(res, j_disba.solve_lambda_bisect(table1, B))
    _close(res, j_disba.disba_sharded(jax.make_mesh((1,), ("data",)),
                                      table1, B))


def test_disba_sharded_default_mesh(table1):
    """``mesh=None`` builds the mesh through ``mesh.flat_mesh`` -- the
    construction path ``run_fleet`` uses -- and equals the explicit one
    bit for bit; a multi-axis ``axis_names`` needs an explicit mesh."""
    t = _port(table1)
    res = disba.disba_sharded(None, t, B)
    ref = disba.disba_sharded(mesh_lib.flat_mesh(axis_name="data"), t, B)
    assert torch.equal(res.b, ref.b) and torch.equal(res.f, ref.f)
    with pytest.raises(ValueError, match="one-axis"):
        disba.disba_sharded(None, t, B, axis_names=("a", "b"))


def test_disba_sharded_masked_padded_matches_dense(table1):
    """All-masked pad rows demand nothing: the padded solve equals the
    dense reference on the real rows and gives the pads exactly 0; a live
    row masked out mid-set behaves the same way."""
    n = table1.n_services
    doubled = j_types.ServiceSet(
        alpha=jnp.concatenate([table1.alpha, jnp.zeros_like(table1.alpha)]),
        t_comp=jnp.concatenate([table1.t_comp,
                                jnp.zeros_like(table1.t_comp)]),
        mask=jnp.concatenate([table1.mask, jnp.zeros_like(table1.mask)]))
    res = disba.disba_sharded(None, _port(doubled), B)
    _close(res._replace(b=res.b[:n]), j_disba.solve_lambda_bisect(table1, B))
    assert not res.b[n:].any() and not res.f[n:].any()
    keep = jnp.arange(2 * n) != 1
    masked = j_types.mask_inactive(doubled, keep)
    sub = j_types.ServiceSet(
        *(jnp.concatenate([x[:1], x[2:]]) for x in
          (table1.alpha, table1.t_comp, table1.mask)))
    res_m = disba.disba_sharded(None, _port(masked), B)
    np.testing.assert_allclose(res_m.b.numpy()[np.asarray(keep)][:n - 1],
                               np.asarray(j_disba.solve_lambda_bisect(sub, B).b),
                               rtol=1e-4, atol=1e-5)
    assert float(res_m.b[1]) == 0.0


@pytest.mark.parametrize("demand_backend", ["reference", "pallas"])
def test_disba_sharded_newton_matches_reference(demand_backend):
    """Sharded Newton from a warm seed: the JAX package's ``disba_sharded``
    with the same backend on its one-device mesh, and its dense warm
    solve."""
    j, t = _pair(8, n=12)
    lam_prev = j_disba.solve_lambda_bisect(j, B).lam * jnp.float32(1.05)
    kw = dict(method="newton", iters=disba.WARM_ITERS,
              demand_backend=demand_backend)
    res = disba.disba_sharded(None, t, B, lam_prev=float(lam_prev), **kw)
    for ref in (j_disba.disba_sharded(None, j, B, lam_prev=lam_prev, **kw),
                j_disba.solve_lambda_newton_warm(j, B, lam_prev)):
        _close(res, ref, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(res.lam), float(ref.lam), rtol=1e-3)


def test_disba_sharded_newton_cold_seed_matches_newton():
    j, t = _pair(9, n=8)
    res = disba.disba_sharded(None, t, B, method="newton", iters=12,
                              newton_inner_iters=disba.BISECT_ITERS)
    _close(res, j_disba.solve_lambda_newton(j, B))


def test_disba_sharded_unknown_method_and_backend_raise():
    _, t = _pair(10, n=4)
    with pytest.raises(ValueError, match="method"):
        disba.disba_sharded(None, t, B, method="simplex")
    with pytest.raises(ValueError, match="demand backend"):
        disba.disba_sharded(None, t, B, method="newton",
                            demand_backend="megakernel")


def test_disba_sharded_bisect_path_unchanged():
    """The default method stays the cold bisection: bit for bit the
    port's dense ``solve_lambda_bisect`` on one rank, and the JAX
    package's within tolerance."""
    j, t = _pair(11, n=8)
    res = disba.disba_sharded(None, t, B)
    dense = disba.solve_lambda_bisect(t, B)
    assert torch.equal(res.b, dense.b) and torch.equal(res.lam, dense.lam)
    _close(res, j_disba.solve_lambda_bisect(j, B))


def test_disba_sharded_abstract_mesh_needs_its_ranks():
    """A mesh that only records a shape cannot reduce over an axis of
    more than one rank."""
    _, t = _pair(12, n=8)
    with pytest.raises(ValueError, match="no process group"):
        disba.disba_sharded(mesh_lib.Mesh(("data",), (4,)), t, B)


# ---------------------------------------------------------------------------
# Eight gloo ranks, one launch for the file.
# ---------------------------------------------------------------------------

def _cases():
    """name -> (JAX set, mesh spec, kwargs) of the eight-rank launch."""
    svc16, _ = j_network.sample_services(jax.random.key(1), 16, k_max=30)
    j12, _ = _pair(13, n=12)
    j16 = _pad(j12, RANKS)
    lam_prev = float(j_disba.solve_lambda_bisect(j16, B).lam) * 1.05
    newton = dict(method="newton", iters=disba.WARM_ITERS, lam_prev=lam_prev)
    flat = ((RANKS,), ("data",))
    return {
        "bisect": (svc16, flat, {}),
        "bisect_default_mesh": (svc16, None, {}),
        "bisect_pod_data": (svc16, ((2, 4), ("pod", "data")),
                            dict(axis_names=("pod", "data"))),
        "bisect_replicated": (svc16, ((4, 2), ("data", "model")), {}),
        "newton_reference": (j16, flat, newton),
        "newton_pallas": (j16, flat, dict(newton, demand_backend="pallas")),
        "newton_cold": (j16, flat, dict(method="newton", iters=12,
                                        newton_inner_iters=48)),
        "uneven": (j12, flat, {}),
    }


@pytest.fixture(scope="module")
def ranks():
    cases = _cases()
    results = launch("disba_sharded", RANKS, {
        name: {"svc": _arrays(j), "mesh": mesh, "B": B, "kw": kw}
        for name, (j, mesh, kw) in cases.items()})
    return cases, results


def _every_rank(results, name):
    """The case's result, the same bits on every rank."""
    first = results[0][name]
    for other in results[1:]:
        for key, value in first.items():
            np.testing.assert_array_equal(other[name][key], value)
    return first


@pytest.mark.parametrize("name", ["bisect", "bisect_default_mesh",
                                  "bisect_pod_data", "bisect_replicated"])
def test_disba_sharded_eight_ranks_bisect(ranks, name):
    cases, results = ranks
    j = cases[name][0]
    got = _every_rank(results, name)
    ref = j_disba.solve_lambda_bisect(j, B)
    np.testing.assert_allclose(got["b"], np.asarray(ref.b), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got["f"], np.asarray(ref.f), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(got["b"].sum()), B, rtol=1e-5)
    # mesh=None is the flat mesh over the world, bit for bit
    np.testing.assert_array_equal(results[0]["bisect_default_mesh"]["b"],
                                  results[0]["bisect"]["b"])


@pytest.mark.parametrize("name", ["newton_reference", "newton_pallas",
                                  "newton_cold"])
def test_disba_sharded_eight_ranks_newton(ranks, name):
    """Newton over eight ranks against the JAX package's dense Newton from
    the same seed (the pad rows get nothing)."""
    cases, results = ranks
    j, _, kw = cases[name]
    got = _every_rank(results, name)
    ref = (j_disba.solve_lambda_newton(j, B) if name == "newton_cold" else
           j_disba.solve_lambda_newton_warm(j, B,
                                            jnp.float32(kw["lam_prev"])))
    np.testing.assert_allclose(got["b"], np.asarray(ref.b), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(got["lam"]), float(ref.lam), rtol=1e-3)
    np.testing.assert_allclose(float(got["b"].sum()), B, rtol=1e-5)
    assert not got["b"][12:].any()


def test_disba_sharded_eight_ranks_uneven_raises(ranks):
    """12 services over 8 ranks: refused, as shard_map refuses them."""
    _, results = ranks
    for rank in results:
        assert "pad the set with all-masked rows" in rank["uneven"]["raises"]


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("method", ["bisect", "newton"])
def test_disba_sharded_on_the_card(method):
    """One rank on the card: Newton on ``"pallas"`` launches B2 once a
    trip on the rank's rows and matches the dense solve there; bisection
    is the dense ``solve_lambda_bisect`` bit for bit."""
    _, t = _pair(14, n=64)
    t = t._replace(**{k: getattr(t, k).to("cuda")
                      for k in ("alpha", "t_comp", "mask")})
    if method == "bisect":
        res, dense = (disba.disba_sharded(None, t, B),
                      disba.solve_lambda_bisect(t, B))
        assert torch.equal(res.b, dense.b)
        return
    lam_prev = float(disba.solve_lambda_bisect(t, B).lam) * 1.05
    dense = disba.solve_lambda_newton_warm(t, B, lam_prev, backend="pallas")
    ops.reset_launches()
    res = disba.disba_sharded(None, t, B, method="newton", lam_prev=lam_prev,
                              iters=disba.WARM_ITERS, demand_backend="pallas")
    assert ops.LAUNCHES["dual_demand"] == disba.WARM_ITERS
    torch.testing.assert_close(res.b, dense.b, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(res.lam, dense.lam, rtol=1e-3, atol=0)
