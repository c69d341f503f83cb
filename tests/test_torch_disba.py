"""The port's DISBA solvers and policies against the JAX package.

Same masked sets (numpy, seeded) through ``repro.core.disba`` /
``repro.core.policy`` and their ``repro_torch`` counterparts on the CPU,
where the ``"pallas"`` and ``"megakernel"`` backends run the kernels' plain
versions.  Tolerances: lambda rtol 1e-4, b rtol 1e-3 / atol 1e-4, f rtol
1e-3 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disba as j_disba
from repro.core import network as j_network
from repro.core import policy as j_policy
from repro.core import types as j_types
from repro_torch import interop
from repro_torch.core import disba, intra, policy

B = 10.0
CPU = torch.device("cpu")


def _pair(seed, n=9, k=31):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.01, 0.3, size=(n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, size=(n, k)).astype(np.float32)
    mask = np.zeros((n, k), dtype=bool)
    for i in range(n):
        mask[i, : rng.integers(2, k + 1)] = True
    mask[rng.integers(0, n)] = False
    a = np.where(mask, alpha, 0.0).astype(np.float32)
    t = np.where(mask, t_comp, 0.0).astype(np.float32)
    j = j_types.ServiceSet(alpha=jnp.asarray(a), t_comp=jnp.asarray(t),
                           mask=jnp.asarray(mask))
    return j, interop.service_set_from_arrays(a, t, mask, device=CPU)


def _same_result(res, ref, lam_rtol=1e-4):
    np.testing.assert_allclose(float(res.lam), float(ref.lam), rtol=lam_rtol)
    np.testing.assert_allclose(res.b.numpy(), np.asarray(ref.b),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.f.numpy(), np.asarray(ref.f),
                               rtol=1e-3, atol=1e-5)


def test_solve_lambda_bisect_matches():
    j, t = _pair(0)
    _same_result(disba.solve_lambda_bisect(t, B), j_disba.solve_lambda_bisect(j, B))


def test_solve_lambda_newton_cold_matches():
    j, t = _pair(1)
    _same_result(disba.solve_lambda_newton(t, B), j_disba.solve_lambda_newton(j, B))


@pytest.mark.parametrize("backend", disba.DEMAND_BACKENDS)
@pytest.mark.parametrize("seed_scale", [1.03, 0.7, None])
def test_solve_lambda_newton_warm_matches(backend, seed_scale):
    j, t = _pair(2)
    lam_prev = (disba.WARM_COLD if seed_scale is None
                else float(j_disba.solve_lambda_bisect(j, B).lam) * seed_scale)
    ref = j_disba.solve_lambda_newton_warm(j, B, jnp.float32(lam_prev))
    res = disba.solve_lambda_newton_warm(t, B, lam_prev, backend=backend)
    _same_result(res, ref)
    assert not bool(res.fallback)


def test_disba_algorithm1_matches():
    """The paper's subgradient loop on the Table I set (§VI.B)."""
    j, _ = j_network.table1_service_set(jax.random.key(0))
    t = interop.service_set_from_arrays(j.alpha, j.t_comp, j.mask, device=CPU)
    ref = j_disba.disba(j, B, gamma=0.1, eps=1e-4)
    res = disba.disba(t, B, gamma=0.1, eps=1e-4)
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) and bool(ref.converged)
    _same_result(res, ref)


def test_disba_trace_matches():
    j, t = _pair(4, n=5, k=12)
    ref = j_disba.disba_trace(j, B, gamma=0.5, diminishing=True)
    res = disba.disba_trace(t, B, gamma=0.5, diminishing=True)
    assert res["iterations"] == ref["iterations"]
    assert res["converged"] == ref["converged"]
    np.testing.assert_allclose(res["lam"], ref["lam"], rtol=1e-4)
    np.testing.assert_allclose(res["b_final"].numpy(), np.asarray(ref["b_final"]),
                               rtol=1e-3, atol=1e-4)


def test_demand_slope_values_and_objective_match():
    j, t = _pair(5)
    lam = 0.3 * float(jnp.max(1.0 / jnp.maximum(j.alpha_sum(), 1e-30)))
    jb, js = j_disba.demand_slope_values(j, lam)
    tb, ts = disba.demand_slope_values(t, lam)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-4)
    b = np.array(j_disba.solve_lambda_bisect(j, B).b)
    np.testing.assert_allclose(float(disba.objective(t, torch.as_tensor(b))),
                               float(j_disba.objective(j, jnp.asarray(b))),
                               rtol=1e-5)


@pytest.mark.parametrize("backend", disba.DEMAND_BACKENDS)
def test_nonfinite_set_takes_the_rescue(backend):
    """A NaN in a masked-in entry sets ``fallback`` and the result is the
    finite cold-bisection rescue on the sanitized set (disba.py:395-413)."""
    j, t = _pair(6)
    a = np.array(j.alpha)
    a[1, 0] = np.nan
    j = j._replace(alpha=jnp.asarray(a))
    t = t._replace(alpha=torch.as_tensor(a))
    ref = j_disba.solve_lambda_newton_warm(j, B, jnp.float32(0.1))
    res = disba.solve_lambda_newton_warm(t, B, 0.1, backend=backend)
    assert bool(res.fallback) and bool(ref.fallback)
    assert bool(torch.isfinite(res.b).all()) and bool(torch.isfinite(res.f).all())
    _same_result(res, ref)


def test_nonfinite_seed_takes_the_rescue():
    j, t = _pair(7)
    ref = j_disba.solve_lambda_newton_warm(j, B, jnp.float32(np.nan))
    res = disba.solve_lambda_newton_warm(t, B, float("nan"))
    assert bool(res.fallback) and bool(ref.fallback)
    _same_result(res, ref)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["coop", "ec", "es", "pp"])
@pytest.mark.parametrize("backend", policy.INTRA_BACKENDS)
def test_policies_match(name, backend):
    j, t = _pair(8)
    jb, jf = j_policy.get_policy(name, intra_backend=backend)(j, B)
    tb, tf = policy.get_policy(name, intra_backend=backend)(t, B)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("backend", policy.INTRA_BACKENDS)
def test_warm_coop_step_and_carry_match(backend):
    j, t = _pair(9)
    jp = j_policy.get_stateful_policy("coop", warm_start=True,
                                      intra_backend=backend)
    tp = policy.get_stateful_policy("coop", warm_start=True,
                                    intra_backend=backend)
    js, ts = jp.init_state(9), tp.init_state(9, CPU)
    for _ in range(2):
        jb, jf, js = jp.step(j, B, js)
        tb, tf, ts = tp.step(t, B, ts)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(float(ts.lam), float(js.lam), rtol=1e-4)
    assert policy.fallback_count(ts) == j_policy.fallback_count(js) == 0
    carried = interop.warm_state_from_arrays(np.asarray(js.lam),
                                             np.asarray(js.fallbacks), device=CPU)
    assert float(carried.lam) == float(js.lam)


@pytest.mark.parametrize("name,warm", [("coop", False), ("coop", True),
                                       ("es", False), ("pp", False)])
@pytest.mark.parametrize("backend", ["pallas", "megakernel"])
def test_kernel_backends_never_evaluate_the_plain_freq(monkeypatch, name, warm,
                                                       backend):
    """On a kernel backend f*(b) is computed once, by that backend: the
    plain ``intra.freq`` is never called, so no dead work runs beside the
    kernel."""
    j, t = _pair(10)

    def plain_freq(*args, **kwargs):
        raise AssertionError("the plain intra.freq ran on a kernel backend")

    want_b, want_f = policy.get_policy(name, intra_backend=backend)(t, B)
    pol = policy.get_stateful_policy(name, warm_start=warm,
                                     intra_backend=backend)
    monkeypatch.setattr(intra, "freq", plain_freq)
    b, f, state = pol.step(t, B, pol.init_state(9, CPU))
    assert policy.fallback_count(state) == 0
    assert bool(torch.isfinite(f).all()) and bool((f[b > 0] > 0).all())
    if not warm:
        assert torch.equal(b, want_b) and torch.equal(f, want_f)


def test_registry_options_and_unported_policy():
    assert policy.available() == ("coop", "ec", "es", "pp")
    assert policy.KNOWN_OPTIONS == j_policy.KNOWN_OPTIONS
    with pytest.raises(ValueError, match="not yet ported"):
        policy.get_policy("selfish")
    with pytest.raises(ValueError, match="unknown option"):
        policy.get_policy("coop", alpha_fiar=0.3)
    with pytest.raises(ValueError, match="unknown policy"):
        policy.get_stateful_policy("nope")
    with pytest.raises(ValueError, match="unknown intra backend"):
        policy.freq_fn("tpu")
