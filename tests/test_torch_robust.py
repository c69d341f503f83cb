"""Adversarial participants in the port (``repro_torch.chaos.clients`` /
``bids``, co-training's ``attack=``) against the JAX package's.

Exact: ``AttackSpec`` validation, ``ClientChaos.plan`` (numpy in both),
``attack_fn`` on the same arrays, ``BidChaos.draw``, and an attacked
episode's durations, rounds and participants.  An attacked co-trained
episode, fed the reference's draws, batches and initial tables
(``test_torch_cotrain.ref_inputs``), matches the reference's attacked
episode at ``test_torch_cotrain``'s tolerances.  The attack never touches
the allocation: the attacked episode's durations and allocation are
bitwise its unattacked ones and ``run_scan``'s.  Audited bid deviations
agree with the reference's within rtol 1e-3 / atol 1e-4 and stay under
the truthfulness bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import bids as j_bids
from repro.chaos import clients as j_clients
from repro.chaos import invariants as j_invariants
from repro.core import network as j_network
from repro.fl import cotrain as j_cotrain
from repro_torch import interop
from repro_torch.chaos import invariants
from repro_torch.chaos.bids import BidChaos, audit_deviation, deviate_bid
from repro_torch.chaos.clients import (ATTACKS, AttackSpec, ClientChaos,
                                       attack_fn)
from repro_torch.core import auction
from repro_torch.fl import cotrain, server, simulator
from test_torch_cotrain import NET, TRAIN, J_NET, assert_matches, ref_inputs

CPU = torch.device("cpu")


def test_attack_spec_validation_matches_reference():
    assert ATTACKS == j_clients.ATTACKS
    for kw, match in ((dict(attack="teleport"), "attack"),
                      (dict(byz_frac=1.5), "byz_frac"),
                      (dict(byz_frac=-0.1), "byz_frac")):
        with pytest.raises(ValueError, match=match) as got:
            AttackSpec(**kw)
        with pytest.raises(ValueError) as want:
            j_clients.AttackSpec(**kw)
        assert str(got.value) == str(want.value)
    assert dataclasses.astuple(AttackSpec()) == dataclasses.astuple(
        j_clients.AttackSpec())
    with pytest.raises(TypeError, match="AttackSpec"):
        server.make_fl_round_step(cotrain.bigram_loss, attack="sign_flip")


@pytest.mark.parametrize("seed,frac", [(0, 0.2), (3, 0.5), (9, 0.05)])
def test_client_plan_equals_reference(seed, frac):
    spec = AttackSpec(byz_frac=frac, seed=seed)
    got = ClientChaos(spec).plan(7, 3, 10)
    want = j_clients.ClientChaos(j_clients.AttackSpec(
        byz_frac=frac, seed=seed)).plan(7, 3, 10)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("attack", ATTACKS)
def test_attack_fn_equals_reference(attack):
    rng = np.random.default_rng(4)
    deltas = {"w": rng.normal(size=(6, 3, 2)).astype(np.float32),
              "b": rng.normal(size=(6, 4)).astype(np.float32)}
    weights = np.array([1.0, 0.0, 2.0, 1.0, 0.5, 0.0], np.float32)
    byz = np.array([True, True, False, False, True, False])
    got_d, got_w = attack_fn(AttackSpec(attack=attack, scale=3.0))(
        {k: torch.from_numpy(v) for k, v in deltas.items()},
        torch.from_numpy(weights), torch.from_numpy(byz))
    want_d, want_w = j_clients.attack_fn(
        j_clients.AttackSpec(attack=attack, scale=3.0))(
        {k: jnp.asarray(v) for k, v in deltas.items()}, jnp.asarray(weights),
        jnp.asarray(byz))
    for k in deltas:
        np.testing.assert_array_equal(got_d[k].numpy(), np.asarray(want_d[k]))
        # honest clients pass through bitwise
        np.testing.assert_array_equal(got_d[k].numpy()[~byz], deltas[k][~byz])
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


# (attack, aggregator): a plain mean under sign flips and inflated
# weights; NaN uploads against a robust aggregator.
ATTACK_CASES = [("sign_flip", "fedavg", {}),
                ("nan", "trimmed_mean", dict(trim_frac=0.25)),
                ("inflate_weight", "median", {})]


@pytest.mark.parametrize("attack,aggregator,extra", ATTACK_CASES)
def test_attacked_episode_matches_reference(attack, aggregator, extra):
    train_kw = dict(aggregator=aggregator, byz_f=3, **extra)
    j_cfg, cfg, j_train, train, inject = ref_inputs(
        dict(policy="coop", warm_start=True), train_kw)
    kw = dict(attack=attack, byz_frac=0.2, scale=20.0, seed=1)
    want = j_cotrain.run_cotrain_scan(j_cfg, j_train, J_NET,
                                      attack=j_clients.AttackSpec(**kw))
    got = cotrain.run_cotrain_scan(cfg, train, NET,
                                   attack=AttackSpec(**kw), **inject)
    assert_matches(got, want, train)
    assert invariants.params_finite(got["params"])["ok"] == (
        j_invariants.params_finite(want["params"])["ok"])
    if attack == "nan":
        assert invariants.params_finite(got["params"])["ok"]


def test_attack_never_touches_the_allocation_stream():
    """The attacked episode's durations and per-period allocation are
    bitwise the unattacked one's and run_scan's (the port's own draws,
    kernel backends' plain versions)."""
    base = dict(n_services_total=3, rounds_required=30, p_arrive=2.0,
                max_periods=24, k_max=12, mean_clients=5.0, var_clients=2.0)
    cfg = simulator.SimConfig(**base, policy="coop", warm_start=True,
                              intra_backend="megakernel", collect_alloc=True)
    plain = simulator.run_scan(cfg, NET, device=CPU)
    train = cotrain.TrainSpec(**TRAIN)
    clean = cotrain.run_cotrain_scan(cfg, train, NET, device=CPU)
    for aggregator in ("fedavg", "trimmed_mean", "median"):
        spec = dataclasses.replace(train, aggregator=aggregator,
                                   trim_frac=0.25)
        for attack in ("sign_flip", "nan"):
            got = cotrain.run_cotrain_scan(
                cfg, spec, NET, device=CPU,
                attack=AttackSpec(attack=attack, scale=20.0, seed=1))
            assert got["durations"] == plain["durations"] == \
                clean["durations"]
            for key in ("b", "f", "active", "rounds", "trained",
                        "participants"):
                np.testing.assert_array_equal(got["history"][key],
                                              clean["history"][key])
            if aggregator != "fedavg" or attack != "nan":
                assert invariants.params_finite(got["params"])["ok"]


def test_attacked_batch_and_fleet_are_the_scan_per_seed():
    cfg = simulator.SimConfig(n_services_total=2, rounds_required=20,
                              p_arrive=2.0, max_periods=12, k_max=8,
                              mean_clients=5.0, var_clients=2.0, policy="pp")
    train = cotrain.TrainSpec(**TRAIN, aggregator="median")
    attack = AttackSpec(attack="sign_flip", byz_frac=0.3, scale=5.0)
    batch = cotrain.run_cotrain_batch(cfg, train, [0, 1], NET, device=CPU,
                                      attack=attack)
    fleet = cotrain.run_cotrain_fleet(cfg, train, [0, 1], NET, chunk_size=1,
                                      device=CPU, attack=attack)
    np.testing.assert_array_equal(batch["params"], fleet["params"])
    for i, seed in enumerate((0, 1)):
        one = cotrain.run_cotrain_scan(dataclasses.replace(cfg, seed=seed),
                                       train, NET, device=CPU, attack=attack)
        np.testing.assert_array_equal(batch["params"][i], one["params"])
        assert list(batch["durations"][i]) == one["durations"]


def _bid_setup():
    j_svc, _ = j_network.sample_services(jax.random.key(0), 5)
    svc = interop.service_set_from_arrays(
        *(np.asarray(x) for x in j_svc), device=CPU)
    return j_svc, svc, j_network.B_TOTAL_MHZ


def test_bid_chaos_draws_equal_reference():
    for seed in (5, 11):
        got, want = BidChaos(seed), j_bids.BidChaos(seed)
        for trial in range(24):
            assert got.draw(trial, 5) == want.draw(trial, 5)


@pytest.mark.parametrize("n,kind,factor", [(0, "shade", 0.5),
                                           (2, "overbid", 2.5),
                                           (4, "free_ride", 0.0)])
def test_audit_deviation_matches_reference(n, kind, factor):
    j_svc, svc, b_total = _bid_setup()
    got = audit_deviation(svc, b_total, n, kind, factor)
    want = j_bids.audit_deviation(j_svc, b_total, n, kind, factor)
    assert {k: got[k] for k in ("provider", "deviation", "factor")} == {
        k: want[k] for k in ("provider", "deviation", "factor")}
    for key in ("u_truthful", "u_deviated", "gain", "regret", "delta_bound"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4,
                                   err_msg=key)
    assert got["regret"] == max(0.0, got["gain"])


def test_deviate_bid_validation():
    _, svc, _ = _bid_setup()
    truthful = auction.uniform_truthful_bids(svc, 5, 0.5)
    dev = deviate_bid(truthful, 1, "overbid", 2.0)
    np.testing.assert_allclose(dev.demands[1].numpy(),
                               truthful.demands[1].numpy() * 2.0)
    np.testing.assert_array_equal(dev.demands[0].numpy(),
                                  truthful.demands[0].numpy())
    free = deviate_bid(truthful, 2, "free_ride", 0.0)
    np.testing.assert_array_equal(free.demands[2][1:].numpy(), 0.0)
    with pytest.raises(ValueError, match="deviation"):
        deviate_bid(truthful, 0, "bribe", 1.0)


def test_regret_bounded_and_gates():
    _, svc, b_total = _bid_setup()
    rows = BidChaos(seed=11).run(svc, b_total, n_trials=4)
    gate = invariants.regret_bounded(rows)
    assert gate["ok"], gate
    assert gate["n_audited"] == 4 and [r["trial"] for r in rows] == [0, 1,
                                                                     2, 3]
    bad = dict(rows[0], gain=rows[0]["delta_bound"] + 1.0)
    assert not invariants.regret_bounded(rows + [bad])["ok"]
    assert invariants.accuracy_bounded(0.6, 0.55)["ok"]
    assert not invariants.accuracy_bounded(0.6, float("nan"))["ok"]
    assert invariants.params_finite({"w": torch.ones(3)})["ok"]
    assert not invariants.params_finite(
        {"w": torch.tensor([1.0, float("nan")])})["ok"]
    with pytest.raises(AssertionError, match="accuracy"):
        invariants.assert_robust(
            {"accuracy": invariants.accuracy_bounded(0.6, 0.1)})
