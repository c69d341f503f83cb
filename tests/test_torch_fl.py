"""The port's FL runtime (``fl.compression``, ``fl.aggregation``,
``fl.server``, ``fl.client``, ``fl.service``) against the JAX package's,
on the same seeded numpy arrays.

Compression keeps the same entries (top-k ties to the lowest index, int8
rounding half to even) and so the same values to float32 rounding
(rtol 1e-6 / atol 1e-7); aggregators, FedAvg and local updates agree to
atol 1e-6; a bigram round step (with and without error feedback) to
atol 1e-5 in params, metrics and residuals.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.fl import aggregation as j_agg
from repro.fl import client as j_client
from repro.fl import compression as j_comp
from repro.fl import server as j_server
from repro.fl import service as j_service
from repro_torch import configs
from repro_torch.fl import aggregation, client, compression, server, service
from repro_torch.fl.cotrain import bigram_loss


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=1e-6, atol=1e-7):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _leaves(rng):
    """A delta tree with an ordinary leaf, an all-zero leaf and a leaf of
    ties (many equal magnitudes and exact zeros)."""
    ties = np.zeros((6, 5), np.float32)
    ties[1, :] = 0.5
    ties[3, 2:] = -0.5
    ties[4, 4] = 0.25
    return {"w": rng.normal(size=(8, 5)).astype(np.float32),
            "zero": np.zeros((4, 4), np.float32),
            "ties": ties}


@pytest.mark.parametrize("method", ["none", "topk", "int8", "topk_int8"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_matches_reference(method, with_residual):
    rng = np.random.default_rng(1)
    delta = _leaves(rng)
    resid = ({k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in delta.items()} if with_residual else None)
    for k_frac in (0.1, 0.3):
        want, want_r = j_comp.compress(method, _j(delta), k_frac,
                                       None if resid is None else _j(resid))
        got, got_r = compression.compress(
            method, _t(delta), k_frac, None if resid is None else _t(resid))
        _close(got, want)
        if want_r is None:
            assert got_r is None
        else:
            _close(got_r, want_r)
        if "topk" in method:
            for k in delta:   # the same kept entries, ties included
                assert np.array_equal(np.asarray(got[k]) != 0,
                                      np.asarray(want[k]) != 0), k


def test_topk_keeps_exactly_k_lowest_index_ties():
    x = torch.zeros(10)
    x[7] = 1.0
    out, _ = compression.topk_sparsify({"x": x}, 0.3)
    # k = 3: the one nonzero, then the two lowest-index zeros (kept as 0)
    want, _ = j_comp.topk_sparsify({"x": jnp.asarray(x.numpy())}, 0.3)
    np.testing.assert_array_equal(out["x"].numpy(), np.asarray(want["x"]))
    ties = torch.tensor([0.5, -0.5, 0.5, 0.25, -0.5])
    out, res = compression.topk_sparsify({"x": ties}, 0.4)
    np.testing.assert_array_equal(out["x"].numpy(), [0.5, -0.5, 0, 0, 0])
    np.testing.assert_array_equal(res["x"].numpy(), [0, 0, 0.5, 0.25, -0.5])


def test_int8_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    out, _ = compression.int8_quantize({"x": x})
    want, _ = j_comp.int8_quantize({"x": jnp.asarray(x.numpy())})
    np.testing.assert_array_equal(out["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(out["x"].numpy(),
                                  [127, 0, 2, 2, -0, -2])


def test_compression_ratio_matches_reference():
    for method in compression.METHODS:
        for k_frac, bits in ((0.01, 32), (0.05, 16), (0.9, 32)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = j_comp.compression_ratio(method, k_frac,
                                                index_bits=bits)
            if want == 1.0 and method != "none":
                with pytest.warns(UserWarning, match="clamping"):
                    got = compression.compression_ratio(method, k_frac,
                                                        index_bits=bits)
            else:
                got = compression.compression_ratio(method, k_frac,
                                                    index_bits=bits)
            assert got == want
    with pytest.raises(ValueError):
        compression.compression_ratio("gzip")
    with pytest.raises(ValueError):
        compression.compress("gzip", {})


def _client_deltas(rng, n_clients: int):
    return {"w": rng.normal(size=(n_clients, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(n_clients, 4)).astype(np.float32)}


@pytest.mark.parametrize("name", ["fedavg", "trimmed_mean", "median",
                                  "norm_clip", "krum", "multi_krum"])
@pytest.mark.parametrize("n_clients", [1, 6, 9])
def test_aggregators_match_reference(name, n_clients):
    rng = np.random.default_rng(n_clients)
    deltas = _client_deltas(rng, n_clients)
    weights = rng.uniform(0.2, 2.0, n_clients).astype(np.float32)
    if n_clients > 1:
        weights[0] = 0.0                 # a straggler with a NaN delta
        deltas["w"][0] = np.nan
        deltas["b"][-1, 2] = np.inf      # a participant sending Inf
    opts = dict(trim_frac=0.2, byz_f=1)
    for w in (weights, np.zeros_like(weights)):
        want = j_agg.get_aggregator(name, **opts)(_j(deltas), jnp.asarray(w))
        got = aggregation.get_aggregator(name, **opts)(
            _t(deltas), torch.from_numpy(w))
        if name == "fedavg" and n_clients > 1 and w.any():
            # plain fedavg trusts the weight mask only: the Inf passes
            np.testing.assert_array_equal(np.isfinite(got["b"].numpy()),
                                          np.isfinite(np.asarray(want["b"])))
            _close({"w": got["w"]}, {"w": want["w"]}, atol=1e-6)
            continue
        _close(got, want, rtol=1e-5, atol=1e-6)
        if not w.any():
            for v in got.values():
                assert not v.any()


def test_norm_clip_fixed_radius_and_participation():
    rng = np.random.default_rng(3)
    deltas = _client_deltas(rng, 5)
    w = np.array([1, 0, 2, 1, 1], np.float32)
    want = j_agg.get_aggregator("norm_clip", clip_norm=0.5)(_j(deltas),
                                                            jnp.asarray(w))
    got = aggregation.get_aggregator("norm_clip", clip_norm=0.5)(
        _t(deltas), torch.from_numpy(w))
    _close(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        aggregation.participation(_t(deltas), torch.from_numpy(w)).numpy(),
        np.asarray(j_agg.participation(_j(deltas), jnp.asarray(w))))
    assert aggregation.available() == j_agg.available()
    assert aggregation.KNOWN_OPTIONS == j_agg.KNOWN_OPTIONS
    with pytest.raises(ValueError, match="unknown aggregator options"):
        aggregation.get_aggregator("krum", foo=1)
    with pytest.raises(ValueError, match="trim_frac"):
        aggregation.get_aggregator("trimmed_mean", trim_frac=0.5)


def test_krum_ties_go_to_the_lowest_index():
    # three identical clients: every score ties, the first wins
    d = {"w": np.tile(np.arange(4, dtype=np.float32), (3, 1))}
    d["w"][2] += 10.0
    d["w"][1] = d["w"][0]
    w = np.ones(3, np.float32)
    got = aggregation.get_aggregator("krum", byz_f=0)(_t(d),
                                                      torch.from_numpy(w))
    want = j_agg.get_aggregator("krum", byz_f=0)(_j(d), jnp.asarray(w))
    _close(got, want)


def test_fedavg_sanitize_and_straggler_weights():
    rng = np.random.default_rng(4)
    deltas = _client_deltas(rng, 5)
    w = np.array([1.0, np.nan, 3.0, np.inf, 0.5], np.float32)
    for cap in (None, 1.5):
        got_w, got_bad = server.sanitize_weights(torch.from_numpy(w), cap)
        want_w, want_bad = j_server.sanitize_weights(jnp.asarray(w), cap)
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        assert int(got_bad) == int(want_bad) == 2
        _close(server.fedavg_round(_t(deltas), torch.from_numpy(w), cap),
               j_server.fedavg_round(_j(deltas), jnp.asarray(w), cap),
               atol=1e-6)
    lat = np.array([0.1, 0.5, 0.3, 0.7], np.float32)
    np.testing.assert_array_equal(
        server.straggler_weights(torch.from_numpy(lat), 0.4).numpy(),
        np.asarray(j_server.straggler_weights(jnp.asarray(lat), 0.4)))
    res = server.init_residuals({"w": torch.zeros(3, 2)}, 4)
    assert res["w"].shape == (4, 3, 2) and not res["w"].any()


def _j_bigram_loss(table, batch):
    logits = table[batch["tokens"]]
    logp = jax.nn.log_softmax(logits)
    ll = jnp.take_along_axis(logp, batch["labels"][..., None], axis=-1)[..., 0]
    return -jnp.mean(ll)


def _bigram_batches(rng, n_clients, steps, vocab=12, b=3, s=5):
    tokens = rng.integers(0, vocab, size=(n_clients, steps, b, s + 1))
    return {"tokens": tokens[..., :-1].astype(np.int32),
            "labels": tokens[..., 1:].astype(np.int32)}


def test_local_update_with_prox_matches_reference():
    rng = np.random.default_rng(5)
    table = (0.3 * rng.normal(size=(12, 12))).astype(np.float32)
    batches = {k: v[0] for k, v in _bigram_batches(rng, 1, 3).items()}
    for mu in (0.0, 0.7):
        want_d, want_l = j_client.local_update(
            _j_bigram_loss, jnp.asarray(table), _j(batches), lr=0.4,
            prox_mu=mu)
        got_d, got_l = client.local_update(
            bigram_loss, torch.from_numpy(table),
            {k: torch.from_numpy(v).long() for k, v in batches.items()},
            lr=0.4, prox_mu=mu)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   atol=1e-6)
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("compress", ["none", "topk", "int8"])
def test_round_step_matches_reference(ef, compress):
    rng = np.random.default_rng(6)
    n_clients = 5
    table = (0.3 * rng.normal(size=(12, 12))).astype(np.float32)
    batches = _bigram_batches(rng, n_clients, 2)
    w = np.array([1, 1, 0, 1, 1], np.float32)
    kw = dict(client_lr=0.5, compression=compress, topk_frac=0.1,
              error_feedback=ef, prox_mu=0.1)
    t_batches = {k: torch.from_numpy(v).long() for k, v in batches.items()}
    args_j = (jnp.asarray(table), _j(batches), jnp.asarray(w))
    args_t = (torch.from_numpy(table), t_batches, torch.from_numpy(w))
    if ef:
        resid = (0.01 * rng.normal(size=(n_clients, 12, 12))).astype(
            np.float32)
        args_j += (jnp.asarray(resid),)
        args_t += (torch.from_numpy(resid),)
    want = j_server.make_fl_round_step(_j_bigram_loss, **kw)(*args_j)
    got = server.make_fl_round_step(bigram_loss, **kw)(*args_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(float(got[1]["loss"]),
                               float(want[1]["loss"]), atol=1e-5)
    assert int(got[1]["participating"]) == int(want[1]["participating"])
    if ef:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=1e-5)
        # the straggler's residual is untouched
        np.testing.assert_array_equal(got[2][2].numpy(), args_t[3][2].numpy())


def test_episode_services_and_model_costs_match_reference():
    arrivals, counts = np.array([0, 2, 5]), np.array([7, 9, 4])
    done, dur = np.array([30, 12, 30]), np.array([4, 9, 3])
    assert ([dataclasses.astuple(s) for s in service.episode_services(
                arrivals, counts, done, dur, 30)]
            == [dataclasses.astuple(s) for s in j_service.episode_services(
                arrivals, counts, done, dur, 30)])
    assert [s.finished for s in service.episode_services(
        arrivals, counts, done, dur, 30)] == [True, False, True]
    for arch in ("gemma3-1b", "xlstm-1.3b"):
        cfg, j_cfg = (configs.get_smoke_config(arch),
                      j_configs.get_smoke_config(arch))
        for bits in (32, 16):
            assert service.model_bits(cfg, bits) == j_service.model_bits(
                j_cfg, bits)
            assert service.model_bits(cfg, bits, active_only=True) == \
                j_service.model_bits(j_cfg, bits, active_only=True)
        assert service.train_flops_per_token(cfg) == \
            j_service.train_flops_per_token(j_cfg)
        r = np.array([3.0, 4.0, 5.0], np.float32)
        flops = np.array([1e12, 2e12, 4e12], np.float32)
        got = service.arch_service_tuple(
            cfg, r_dl=torch.from_numpy(r), r_ul=torch.from_numpy(r / 2),
            client_flops=torch.from_numpy(flops), uplink_compression=0.25)
        want = j_service.arch_service_tuple(
            j_cfg, r_dl=jnp.asarray(r), r_ul=jnp.asarray(r / 2),
            client_flops=jnp.asarray(flops), uplink_compression=0.25)
        assert (got.s_dl_mbit, got.s_ul_mbit, got.t_global) == (
            want.s_dl_mbit, want.s_ul_mbit, want.t_global)
        np.testing.assert_allclose(got.t_local.numpy(),
                                   np.asarray(want.t_local), rtol=1e-6)
    with pytest.raises(ValueError, match="uplink_compression"):
        service.arch_service_tuple(cfg, r_dl=torch.ones(2),
                                   r_ul=torch.ones(2),
                                   client_flops=torch.ones(2),
                                   uplink_compression=1.5)
