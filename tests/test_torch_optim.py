"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``): the same gradient sequence (numpy, seeded) fed to both
gives the same params and moments.

Tolerance: 1e-6 relative to each leaf's largest |value| (the update math
is float32 in both; ``b ** step`` and ``sqrt`` may round differently in
XLA and PyTorch by an ulp).  bf16 moments are compared after the same
rounding, within one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro_torch import optim
from repro_torch.tree import leaves

RTOL = 1e-6
N_STEPS = 9


def _tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal((7,)).astype(np.float32)},
                       {"b": rng.standard_normal((7,)).astype(np.float32)}]}


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        g = g.float().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float32)
        scale = max(float(np.max(np.abs(w))), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)


# (label, JAX optimizer, port optimizer, bf16 moments)
CASES = [
    ("adamw", lambda: j_optim.adamw(lr=1e-2),
     lambda: optim.adamw(lr=1e-2), False),
    ("adamw_decay_clip", lambda: j_optim.adamw(
        lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1,
        max_grad_norm=0.5),
     lambda: optim.adamw(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6,
                         weight_decay=0.1, max_grad_norm=0.5), False),
    ("adamw_bf16_moments", lambda: j_optim.adamw(
        lr=1e-2, weight_decay=0.01, moment_dtype=jnp.bfloat16),
     lambda: optim.adamw(lr=1e-2, weight_decay=0.01,
                         moment_dtype=torch.bfloat16), True),
    ("adamw_cosine", lambda: j_optim.adamw(
        lr=j_optim.cosine_schedule(1e-2, 6, final_frac=0.2)),
     lambda: optim.adamw(lr=optim.cosine_schedule(1e-2, 6, final_frac=0.2)),
     False),
    ("adamw_warmup_cosine", lambda: j_optim.adamw(
        lr=j_optim.linear_warmup_cosine(1e-2, 3, 8), max_grad_norm=1.0),
     lambda: optim.adamw(lr=optim.linear_warmup_cosine(1e-2, 3, 8),
                         max_grad_norm=1.0), False),
    ("sgd", lambda: j_optim.sgd(lr=0.05),
     lambda: optim.sgd(lr=0.05), False),
    ("sgd_momentum_clip", lambda: j_optim.sgd(
        lr=j_optim.cosine_schedule(0.1, 5), momentum=0.9, max_grad_norm=0.3),
     lambda: optim.sgd(lr=optim.cosine_schedule(0.1, 5), momentum=0.9,
                       max_grad_norm=0.3), False),
]


@pytest.mark.parametrize("label,j_make,make,bf16", CASES,
                         ids=[c[0] for c in CASES])
def test_optimizer_matches_jax(label, j_make, make, bf16):
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(N_STEPS)]
    j_init, j_update = j_make()
    init, update = make()
    j_params, params = _jax(p0), _torch(p0)
    j_state, state = j_init(j_params), init(params)
    for g in grads:
        j_params, j_state = j_update(_jax(g), j_state, j_params)
        params, state = update(_torch(g), state, params)
        _close(params, j_params)
    assert int(state.step) == int(j_state.step) == N_STEPS
    if state.mu is not None:
        if bf16:
            assert leaves(state.mu)[0].dtype == torch.bfloat16
            _close(state.mu, j_state.mu, rtol=2 ** -7)
            _close(state.nu, j_state.nu, rtol=2 ** -7)
        else:
            _close(state.mu, j_state.mu)
            if state.nu is not None:
                _close(state.nu, j_state.nu)
    else:
        assert j_state.mu is None


@pytest.mark.parametrize("step", [0, 1, 2, 5, 7, 12])
def test_schedules_match_jax(step):
    for j_lr, lr in (
            (j_optim.cosine_schedule(0.3, 10), optim.cosine_schedule(0.3, 10)),
            (j_optim.linear_warmup_cosine(0.3, 4, 10),
             optim.linear_warmup_cosine(0.3, 4, 10))):
        want = float(j_lr(jnp.asarray(step, jnp.int32)))
        got = float(lr(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL)


def test_clip_by_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(4))
    j_clipped, j_norm = j_optim.clip_by_global_norm(_jax(tree), 1.5)
    clipped, norm = optim.clip_by_global_norm(_torch(tree), 1.5)
    assert float(norm) == pytest.approx(float(j_norm), rel=RTOL)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.5, rel=1e-5)
    _close(clipped, j_clipped)
    same, _ = optim.clip_by_global_norm(_torch(tree), 1e6)
    _close(same, _jax(tree))


def test_adamw_descends_quadratic():
    init, update = optim.adamw(lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init(params)
    for _ in range(200):
        params, state = update({"w": 2 * params["w"]}, state, params)
    assert float(torch.max(torch.abs(params["w"]))) < 1e-2


def test_sgd_momentum_descends():
    init, update = optim.sgd(lr=0.05, momentum=0.9)
    params = {"w": torch.tensor([3.0])}
    state = init(params)
    for _ in range(200):
        params, state = update({"w": 2 * params["w"]}, state, params)
    assert abs(float(params["w"][0])) < 1e-2


def test_update_keeps_param_dtypes_and_works_under_grad():
    """bf16 params come back bf16 (math in float32); the pair composes
    with torch.func (nothing updated in place)."""
    init, update = optim.adamw(lr=1e-2, moment_dtype=torch.bfloat16)
    params = {"a": torch.ones((4,), dtype=torch.bfloat16),
              "b": torch.ones((2,))}
    state = init(params)
    new, state = update(params, state, params)
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert state.mu["b"].dtype == torch.bfloat16

    def loss(p):
        return torch.sum(p["b"] ** 2)

    g = torch.func.grad(loss)({"b": torch.tensor([1.0, -2.0])})
    s_init, s_update = optim.sgd(lr=0.25)
    stepped, _ = s_update(g, s_init(g), {"b": torch.tensor([1.0, -2.0])})
    torch.testing.assert_close(stepped["b"], torch.tensor([0.5, -1.0]))
