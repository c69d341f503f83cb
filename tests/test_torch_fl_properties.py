"""Property-based tests (hypothesis) of the port's FedAvg aggregation and
compression, the properties ``tests/test_fl_properties.py`` holds the JAX
package to: the weighted average is invariant under client permutation,
dropped clients (weight 0) never contribute, not even non-finite deltas,
the all-straggler round is the exact identity on params, error feedback
telescopes, residuals keep their leaf's dtype, and int8's round-trip error
is at most half a step."""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
import hypothesis.strategies as st  # noqa: E402

from repro_torch.fl import compression, server  # noqa: E402


def _deltas(rng, n_clients: int):
    return {"w": torch.from_numpy(
                rng.normal(size=(n_clients, 3, 2)).astype(np.float32)),
            "b": torch.from_numpy(
                rng.normal(size=(n_clients, 4)).astype(np.float32))}


def _weights(rng, n_clients: int, p_drop: float):
    w = rng.uniform(0.1, 2.0, size=n_clients)
    w[rng.uniform(size=n_clients) < p_drop] = 0.0
    return torch.from_numpy(w.astype(np.float32))


@hypothesis.settings(deadline=None, max_examples=30)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), n_clients=st.integers(1, 12),
                  p_drop=st.floats(0.0, 0.9))
def test_fedavg_round_permutation_invariant(seed, n_clients, p_drop):
    rng = np.random.default_rng(seed)
    deltas = _deltas(rng, n_clients)
    weights = _weights(rng, n_clients, p_drop)
    perm = torch.from_numpy(rng.permutation(n_clients))
    base = server.fedavg_round(deltas, weights)
    permuted = server.fedavg_round({k: d[perm] for k, d in deltas.items()},
                                   weights[perm])
    for k in base:
        np.testing.assert_allclose(base[k], permuted[k], rtol=1e-5,
                                   atol=1e-6)


@hypothesis.settings(deadline=None, max_examples=30)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), n_clients=st.integers(2, 12))
def test_dropped_clients_never_contribute(seed, n_clients):
    rng = np.random.default_rng(seed)
    deltas = _deltas(rng, n_clients)
    weights = _weights(rng, n_clients, p_drop=0.5)
    dropped = weights == 0.0
    poison = {k: torch.where(dropped.reshape((-1,) + (1,) * (d.dim() - 1)),
                             torch.nan, d) for k, d in deltas.items()}
    base = server.fedavg_round(deltas, weights)
    poisoned = server.fedavg_round(poison, weights)
    for k in base:
        assert torch.equal(base[k], poisoned[k])
        assert torch.all(torch.isfinite(poisoned[k]))


@hypothesis.settings(deadline=None, max_examples=20)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), n_clients=st.integers(1, 12))
def test_all_straggler_round_is_identity_on_params(seed, n_clients):
    rng = np.random.default_rng(seed)
    deltas = _deltas(rng, n_clients)
    for d in deltas.values():
        d[0] = torch.inf
    zeros = torch.zeros((n_clients,))
    agg = server.fedavg_round(deltas, zeros)
    for k in agg:
        assert not agg[k].any()

    def loss_fn(p, batch):
        return torch.mean((p["w"] * batch["x"] - batch["y"]) ** 2)

    step = server.make_fl_round_step(loss_fn, local_steps=2, client_lr=0.3)
    params = {"w": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}
    batches = {k: torch.from_numpy(
        rng.normal(size=(n_clients, 2, 3)).astype(np.float32))
        for k in ("x", "y")}
    new_params, metrics = step(params, batches, zeros)
    assert torch.equal(new_params["w"], params["w"])
    assert float(metrics["loss"]) == 0.0
    assert int(metrics["participating"]) == 0


@hypothesis.settings(deadline=None, max_examples=25)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), n_rounds=st.integers(1, 12),
                  k_frac=st.floats(0.05, 0.9))
def test_error_feedback_telescopes_exactly(seed, n_rounds, k_frac):
    rng = np.random.default_rng(seed)
    deltas = [{"w": torch.from_numpy(rng.normal(size=(17,)).astype(
        np.float32))} for _ in range(n_rounds)]
    residual = None
    sent = torch.zeros((17,))
    for d in deltas:
        sparse, residual = compression.topk_sparsify(d, k_frac, residual)
        sent = sent + sparse["w"]
    raw = sum(d["w"].double().numpy() for d in deltas)
    np.testing.assert_allclose(
        sent.double().numpy() + residual["w"].double().numpy(), raw,
        rtol=1e-4, atol=1e-4)


@hypothesis.settings(deadline=None, max_examples=10)
@hypothesis.given(seed=st.integers(0, 2**31 - 1))
def test_residual_dtype_preserved(seed):
    rng = np.random.default_rng(seed)
    delta = {"hi": torch.from_numpy(rng.normal(size=(12,)).astype(np.float32)),
             "lo": torch.from_numpy(rng.normal(size=(12,))).to(torch.bfloat16)}
    for fn in (lambda d, r: compression.topk_sparsify(d, 0.25, r),
               compression.int8_quantize):
        residual = None
        for _ in range(3):
            out, residual = fn(delta, residual)
            assert residual["hi"].dtype == torch.float32
            assert residual["lo"].dtype == torch.bfloat16
            assert out["lo"].dtype == torch.bfloat16


@hypothesis.settings(deadline=None, max_examples=30)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), size=st.integers(1, 200),
                  spread=st.floats(1e-3, 1e3))
def test_int8_roundtrip_error_at_most_half_scale(seed, size, spread):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((spread * rng.normal(size=(size,))).astype(
        np.float32))
    deq, res = compression.int8_quantize({"w": x})
    scale = max(float(torch.max(torch.abs(x))), 1e-12) / 127.0
    assert float(torch.max(torch.abs(res["w"]))) <= scale * 0.5 + 1e-6 * scale
    np.testing.assert_allclose((deq["w"] + res["w"]).numpy(), x.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_weighted_mean_matches_manual_reference():
    rng = np.random.default_rng(0)
    deltas = _deltas(rng, 5)
    weights = torch.tensor([1.0, 0.0, 2.0, 0.5, 0.0])
    out = server.fedavg_round(deltas, weights)
    w = weights.numpy()
    for k, d in deltas.items():
        ref = np.tensordot(w, d.numpy(), axes=(0, 0)) / w.sum()
        np.testing.assert_allclose(out[k], ref, rtol=1e-6)
