"""B7's backward (``repro_torch::mlstm_chunk_bwd``) against the JAX package.

* ``mlstm_chunk_bwd_plain`` (the CPU body of the op and the formula the
  CUDA kernels compute, from the forward's chunk states and per-position
  statistics) against ``jax.vjp`` of ``repro.models.ssm.mlstm_chunkwise``
  and against ``torch.autograd`` of ``mlstm_chunk_plain``, in float32:
  two chunks of 256 and a ragged S = 100 (the JAX model takes one chunk
  there, the port its own), Dh 64 and 128, forget gates saturated open
  (f ~ 8), a head scaled so that the exp(-m) floor of the normaliser wins
  at some positions and |N| at others (both branches asserted), an
  initial state that does not require grad.  Tolerance: 1e-5 of each
  output's largest |grad| (float32 rounding).
* Gates saturated shut as well (f ~ -8 or +8 at random): within a chunk
  b_t falls to ~-1000, where float32's spacing is 6e-5, so the decays
  exp(b_t - b_j + ...) carry relative errors of that size, and df is a
  sum of O(1) terms that cancel to ~1e-3.  Both float32 forms stray from
  the truth there (JAX's by up to 5e-4 of the largest |df|), so the port
  and JAX alike are held to a float64 parallel form, within SHUT_TOL:
  1e-4 of the largest |grad| for dq, dk, dv, di, 1e-3 for df.
* The kernels' plain versions one by one: the statistics against the
  float64 parallel form, the scores' W, g and 1 / den rebuilding y, the
  reverse states' dC and dn against autograd of the second half of a
  split sequence with respect to the state handed across, the partial
  sums summing to their totals.
* The ``torch.func`` plumbing: ``torch.library.opcheck`` on both ops,
  ``vmap(grad(...))`` and ``grad(vmap(...))`` through ``ops.mlstm`` equal to
  loops, ``vmap`` alone not taking the forward that saves the states, and
  the refusals (a state that requires grad, a gradient for the
  returned state, a second derivative) naming ROADMAP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.models import ssm as j_ssm
from repro_torch.kernels import mlstm_chunk as mc
from repro_torch.kernels import ops

TOL = 1e-5
SHUT_TOL = (1e-4, 1e-4, 1e-4, 1e-4, 1e-3)   # dq, dk, dv, di, df

# (B, H, S, Dh, gates, with_state): "recipe" is the JAX kernel test's (k /
# sqrt(Dh), i ~ N(0, 0.5), f ~ N(2, 0.5)); "saturated" f ~ N(8, 0.5);
# "shut" f ~ -8 or 8 at random, + N(0, 0.5); "floor" the recipe with head
# 0's q scaled by 1e-3 and i ~ N(0, 2).
CASES = [
    (2, 2, 512, 64, "recipe", False),
    (1, 2, 512, 128, "recipe", True),
    (2, 2, 100, 64, "recipe", False),
    (1, 2, 100, 128, "recipe", True),
    (1, 2, 512, 64, "saturated", False),
    (1, 2, 100, 128, "saturated", True),
    (1, 2, 512, 64, "floor", False),
]


def _inputs(case, seed=0):
    b, h, s, dh, gates, with_state = case
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
                   for _ in range(4))
    k /= np.float32(np.sqrt(dh))
    i_scale = 2.0 if gates == "floor" else 0.5
    ig = (rng.standard_normal((b, h, s)) * i_scale).astype(np.float32)
    if gates in ("saturated", "shut"):
        sign = (rng.choice([-1.0, 1.0], (b, h, s)) if gates == "shut"
                else np.ones((b, h, s)))
        fg = (8.0 * sign + 0.5 * rng.standard_normal((b, h, s))).astype(
            np.float32)
    else:
        fg = (2.0 + 0.5 * rng.standard_normal((b, h, s))).astype(np.float32)
    if gates == "floor":
        q[:, 0] *= np.float32(1e-3)
    state = None
    if with_state:
        state = (0.3 * rng.standard_normal((b, h, dh, dh)),
                 0.3 * rng.standard_normal((b, h, dh)),
                 0.5 * rng.standard_normal((b, h)))
        state = tuple(x.astype(np.float32) for x in state)
    return (q, k, v, ig, fg), state, dy


def _t(arrays):
    return [torch.from_numpy(x) for x in arrays]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _port_grads(args, state, dy):
    t_state = None if state is None else tuple(_t(state))
    y, final, states, stats = mc.mlstm_chunk_fwd_plain(*_t(args), t_state)
    grads = mc.mlstm_chunk_bwd_plain(*_t(args), y, states, final[2], stats,
                                     torch.from_numpy(dy))
    return grads, stats


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_plain_matches_jax_vjp(case):
    args, state, dy = _inputs(case)
    s = case[2]
    chunk = 256 if s % 256 == 0 else s    # the JAX model's choice
    j_state = None if state is None else tuple(jnp.asarray(x) for x in state)

    def fwd(q, k, v, ig, fg):
        return j_ssm.mlstm_chunkwise(q, k, v, ig, fg, j_state, chunk=chunk)[0]

    _, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in args))
    want = vjp(jnp.asarray(dy))
    got, stats = _port_grads(args, state, dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= TOL
    if case[4] == "floor":   # both branches of max(|N|, exp(-m))
        sgn = stats[:, :, 1]
        assert bool((sgn == 0).any()) and bool((sgn != 0).any())


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_bwd_plain_matches_autograd_of_plain(case):
    args, state, dy = _inputs(case, seed=1)
    xs = [x.requires_grad_() for x in _t(args)]
    y, _ = mc.mlstm_chunk_plain(*xs, None if state is None
                                else tuple(_t(state)))
    want = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    got, _ = _port_grads(args, state, dy)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL


def _parallel64(q, k, v, i_gate, f_gate):
    """The parallel form in float64 (its stabilizer detached), the truth
    for ``test_shut_gates_match_float64_as_jax_does``."""
    s, dh = q.shape[2], q.shape[3]
    fcum = torch.cumsum(torch.nn.functional.logsigmoid(f_gate), -1)
    d = fcum[..., :, None] - fcum[..., None, :] + i_gate[..., None, :]
    d = torch.where(torch.ones((s, s), dtype=torch.bool).tril(), d,
                    -torch.inf)
    m = d.amax(-1, keepdim=True).detach()
    w = (q @ k.transpose(-1, -2)) / dh ** 0.5 * torch.exp(d - m)
    return (w / torch.maximum(w.sum(-1, keepdim=True).abs(),
                              torch.exp(-m))) @ v


@pytest.mark.parametrize("s", [100, 512])
def test_shut_gates_match_float64_as_jax_does(s):
    args, _, dy = _inputs((1, 2, s, 64, "shut", False), seed=10)
    x64 = [x.double().requires_grad_() for x in _t(args)]
    truth = torch.autograd.grad(_parallel64(*x64), x64,
                                torch.from_numpy(dy).double())
    chunk = 256 if s % 256 == 0 else s
    _, vjp = jax.vjp(lambda *a: j_ssm.mlstm_chunkwise(*a, chunk=chunk)[0],
                     *(jnp.asarray(x) for x in args))
    want = vjp(jnp.asarray(dy))
    got, _ = _port_grads(args, None, dy)
    for g, w, t, tol in zip(got, want, truth, SHUT_TOL):
        assert _rel(np.asarray(w), t.numpy()) <= tol
        assert _rel(g.numpy(), t.numpy()) <= tol


def _parallel_ell(q, k, ig, fg):
    """m_t + log(den_t) of the parallel form, in float64."""
    q, k, ig, fg = (np.asarray(x, np.float64) for x in (q, k, ig, fg))
    s, dh = q.shape[2], q.shape[3]
    fcum = np.cumsum(-np.log1p(np.exp(-fg)), axis=-1)
    d = fcum[..., :, None] - fcum[..., None, :] + ig[..., None, :]
    d = np.where(np.tril(np.ones((s, s), bool)), d, -np.inf)
    m = d.max(-1)
    w = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(dh) * np.exp(
        d - m[..., None])
    return m + np.log(np.maximum(np.abs(w.sum(-1)), np.exp(-m)))


def test_stats_plain_match_the_parallel_form():
    args, _, _ = _inputs((2, 2, 300, 64, "floor", False), seed=2)
    _, _, stats = mc.mlstm_chunk_fwd_plain(*_t(args))[1:]
    want = _parallel_ell(args[0], args[1], args[3], args[4])
    got = stats[:, :, 0].double().numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=str)
def test_scores_plain_rebuild_y(case):
    """y_t = (g_t q~_t C_c + sum_j W_tj v_j) / den_t from the scores
    kernel's plain outputs and the chunk states."""
    args, state, dy = _inputs(case, seed=3)
    q, k, v, ig, fg = _t(args)
    y, final, states, stats = mc.mlstm_chunk_fwd_plain(
        q, k, v, ig, fg, None if state is None else tuple(_t(state)))
    aux, _, w, ds, g_mat = mc.chunk_scores_plain(
        q, k, v, ig, fg, y, torch.from_numpy(dy), states, final[2], stats)
    s, dh = q.shape[2], q.shape[3]
    for c, lo in enumerate(range(0, s, mc.CHUNK)):
        hi = min(lo + mc.CHUNK, s)
        n = hi - lo
        sc = aux[:, :, :, lo:hi, None]
        rebuilt = ((sc[mc.AUX_G] * (q[:, :, lo:hi] / dh ** 0.5)
                    @ states[0][:, :, c] + w[:, :, c, :n, :n] @ v[:, :, lo:hi])
                   * sc[mc.AUX_INV_DEN])
        assert _rel(rebuilt.numpy(), y[:, :, lo:hi].numpy()) <= TOL
        assert not bool(torch.triu(w[:, :, c], 1).any())
        assert not bool(w[:, :, c, n:].any() or g_mat[:, :, c, :, n:].any())


def test_states_bwd_plain_is_the_gradient_of_the_state_handed_across():
    """dC and dn at the first chunk's end equal autograd's gradient, with
    respect to the state handed across, of <dy, y> over the rest."""
    args, _, dy = _inputs((1, 2, 512, 64, "recipe", False), seed=4)
    x = _t(args)
    y, final, states, stats = mc.mlstm_chunk_fwd_plain(*x)
    dy_t = torch.from_numpy(dy)
    aux, so, *_ = mc.chunk_scores_plain(*x, y, dy_t, states, final[2], stats)
    dcs, dns, p_part = mc.chunk_states_bwd_plain(x[0], dy_t, aux, so, states)
    c1, n1 = (st[:, :, 1].clone().requires_grad_() for st in states[:2])
    second = [a[:, :, 256:] for a in x]
    y2, _ = mc.mlstm_chunk_plain(*second, (c1, n1, states[2][:, :, 1]))
    want_c, want_n = torch.autograd.grad(y2, (c1, n1), dy_t[:, :, 256:])
    assert _rel(dcs[:, :, 0].numpy(), want_c.numpy()) <= TOL
    assert _rel(dns[:, :, 0].numpy(), want_n.numpy()) <= TOL
    assert not bool(dcs[:, :, 1].any() or dns[:, :, 1].any())
    whole = (dcs[:, :, 0] * states[0][:, :, 0]).sum((-1, -2)) + (
        dns[:, :, 0] * states[1][:, :, 0]).sum(-1)
    torch.testing.assert_close(p_part[:, :, 0].sum(-1), whole, rtol=1e-5,
                               atol=1e-6)


def test_grads_and_gates_plain_compose_the_backward():
    """The grads kernel's partial sums over head-dim tiles add up to
    R_t / g_t and Q_j / kvw_j, and the gates kernel's output is the
    composition's di and df."""
    args, _, dy = _inputs((1, 2, 300, 128, "recipe", False), seed=5)
    x = _t(args)
    dy_t = torch.from_numpy(dy)
    y, final, states, stats = mc.mlstm_chunk_fwd_plain(*x)
    aux, so, w, ds, g_mat = mc.chunk_scores_plain(*x, y, dy_t, states,
                                                  final[2], stats)
    dcs, dns, p_part = mc.chunk_states_bwd_plain(x[0], dy_t, aux, so, states)
    dq, dk, dv, r_part, q_part = mc.chunk_grads_plain(
        x[0], x[1], x[2], dy_t, aux, w, ds, states, dcs, dns)
    assert r_part.shape == q_part.shape == (1, 2, 300, 128 // mc.TILE)
    qs = x[0][:, :, :256] / 128 ** 0.5
    dense = (dy_t[:, :, :256] * aux[mc.AUX_INV_DEN, :, :, :256, None]
             ) @ states[0][:, :, 0].transpose(-1, -2)
    want_r = (qs * dense).sum(-1)   # C_0 = 0, n_0 = 0: the first chunk
    torch.testing.assert_close(r_part[:, :, :256].sum(-1), want_r,
                               rtol=1e-5, atol=1e-7)
    di, df = mc.chunk_gates_bwd_plain(x[4], aux, so, g_mat, r_part, q_part,
                                      p_part)
    whole = mc.mlstm_chunk_bwd_plain(*x, y, states, final[2], stats, dy_t)
    for got, want in zip((dq, dk, dv, di, df), whole):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_custom_ops_pass_opcheck():
    args, state, dy = _inputs((1, 2, 40, 64, "recipe", True), seed=6)
    q, k, v, ig, fg = _t(args)
    c0, n0, m0 = _t(state)
    for st in ((None, None, None), (c0, n0, m0)):
        for save in (False, True):
            torch.library.opcheck(ops.mlstm_chunk_op,
                                  (q, k, v, ig, fg, *st, save))
    out = ops.mlstm_chunk_op(q, k, v, ig, fg, c0, n0, m0, True)
    torch.library.opcheck(ops.mlstm_chunk_bwd_op,
                          (q, k, v, ig, fg, out[0], *out[4:7], out[3],
                           out[7], torch.from_numpy(dy)))


def _loss(w, x):
    h = (x @ w).reshape(x.shape[0], x.shape[1], 2, 64).transpose(1, 2)
    y, _ = ops.mlstm(h, h * 0.125, h.flip(-1), h[..., 0] * 0.5,
                     h[..., 1] + 2.0)
    return torch.sum(y ** 2)


def test_vmap_of_grad_through_mlstm_equals_a_loop():
    ops.reset_launches()
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((48, 128)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((3, 2, 37, 48)).astype(
        np.float32))
    want = torch.stack([grad(_loss)(w, x) for x in xs])
    got = vmap(grad(_loss), in_dims=(None, 0))(w, xs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    outer = grad(lambda w: vmap(_loss, in_dims=(None, 0))(w, xs).sum())(w)
    assert _rel(outer.numpy(), want.sum(0).numpy()) <= TOL
    assert ops.LAUNCHES["mlstm_chunk_bwd"] == 0   # the CPU launches none


def test_vmap_without_grad_takes_the_forward_that_saves_nothing(
        monkeypatch):
    """vmap alone (co-training's evaluation) does not go through
    MLSTMChunk, whose forward keeps the chunk states; grad over it does."""
    saves = []
    real = ops.mlstm_chunk_op

    def spy(*args):
        saves.append(args[-1])
        return real(*args)

    monkeypatch.setattr(ops, "mlstm_chunk_op", spy)
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.standard_normal((48, 128)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((3, 2, 37, 48)).astype(
        np.float32))
    vmap(_loss, in_dims=(None, 0))(w, xs)
    assert True not in saves
    grad(lambda w: vmap(_loss, in_dims=(None, 0))(w, xs).sum())(w)
    assert saves and all(saves)


def test_refusals_name_roadmap():
    args, state, _ = _inputs((1, 2, 40, 64, "recipe", True), seed=8)
    xs = [x.requires_grad_() for x in _t(args)]
    st = [x.requires_grad_() for x in _t(state)]
    with pytest.raises(RuntimeError, match="ROADMAP"):
        ops.mlstm(*xs, tuple(st))
    y, (c, n, m) = ops.mlstm(*xs)
    with pytest.raises(RuntimeError, match="ROADMAP"):
        torch.autograd.grad(y.sum() + c.sum(), xs)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (48, 128)).astype(np.float32))
    x = torch.ones((1, 9, 48))
    with pytest.raises(RuntimeError, match="ROADMAP"):
        grad(lambda w: grad(_loss)(w, x).sum())(w)
