"""The port's episode engine ``run_scan`` against the JAX package's.

Torch's generators cannot replay JAX's threefry stream, so the port is fed
the reference's own draws: the arrivals and client counts of
``simulator._static_draws(cfg, net)`` and, per period, the ServiceSet that
``network.sample_services(fold_in(key(cfg.seed + 7), period), ...)`` draws
inside the reference's period step (simulator.py:281-293).  Durations must
be exactly equal; per-period b and f (``collect_alloc=True``) agree to
rtol 1e-3 / atol 1e-4 and rtol 1e-3 / atol 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import network as j_network
from repro.fl import simulator as j_sim
from repro_torch import interop, scenarios
from repro_torch.fl import simulator

CPU = torch.device("cpu")
# Small episodes: 5 services arriving about one period apart, each needing
# a few periods of rounds.
SMALL = dict(n_services_total=5, rounds_required=150, p_arrive=1.0,
             max_periods=24, seed=3, collect_alloc=True)
CASES = [("coop", False), ("coop", True), ("ec", False), ("es", False),
         ("pp", False)]


@pytest.fixture(scope="module")
def reference_draws():
    """Arrivals, counts and every period's ServiceSet of the reference
    episode, as numpy arrays."""
    cfg = j_sim.SimConfig(**SMALL)
    net = j_sim._default_net(cfg)
    arrivals, counts = j_sim._static_draws(cfg, net)
    key = jax.random.key(cfg.seed + 7)
    draw = jax.jit(lambda p: j_network.sample_services(
        jax.random.fold_in(key, p), cfg.n_services_total, net,
        k_max=j_sim._k_cap(cfg), client_counts=counts)[0])
    sets = [tuple(np.array(x) for x in draw(p)) for p in range(cfg.max_periods)]
    return arrivals, counts, sets


def _sampler(sets):
    def sampler(period):
        alpha, t_comp, mask, alpha_ul = sets[period]
        return interop.service_set_from_arrays(alpha, t_comp, mask, alpha_ul,
                                               device=CPU)

    return sampler


@pytest.mark.parametrize("backend", ["reference", "pallas", "megakernel"])
@pytest.mark.parametrize("name,warm", CASES)
def test_run_scan_matches_reference(reference_draws, name, warm, backend):
    arrivals, counts, sets = reference_draws
    opts = dict(SMALL, policy=name, warm_start=warm, intra_backend=backend)
    ref = j_sim.run_scan(j_sim.SimConfig(**opts))
    got = simulator.run_scan(simulator.SimConfig(**opts), arrivals=arrivals,
                             counts=counts, sampler=_sampler(sets), device=CPU)
    assert got["durations"] == ref["durations"]
    assert got["periods"] == ref["periods"]
    assert got["finished"] == ref["finished"]
    assert got["fallbacks"] == 0
    h, rh = got["history"], ref["history"]
    assert np.array_equal(h["active"], rh["active"])
    assert np.array_equal(h["rounds"], rh["rounds"])
    np.testing.assert_allclose(h["b"], rh["b"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h["f"], rh["f"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(h["objective"], rh["objective"], rtol=1e-4)
    assert np.array_equal(h["n_clients"], rh["n_clients"])


def test_aggregate_mode_matches_history(reference_draws):
    arrivals, counts, sets = reference_draws
    cfg = simulator.SimConfig(**SMALL)
    full = simulator.run_scan(cfg, arrivals=arrivals, counts=counts,
                              sampler=_sampler(sets), device=CPU)
    agg = simulator.run_scan(
        dataclasses.replace(cfg, collect_history=False, collect_alloc=False),
        arrivals=arrivals, counts=counts, sampler=_sampler(sets), device=CPU)
    assert agg["history"] is None and agg["durations"] == full["durations"]
    for key in ("freq_sum", "n_active", "n_clients"):
        np.testing.assert_allclose(agg["totals"][key],
                                   np.sum(full["history"][key]), rtol=1e-5)


def test_sim_config_and_capacity_match_reference():
    fields = {f.name: f.default for f in dataclasses.fields(simulator.SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(j_sim.SimConfig)}
    assert fields == ref
    cfg = simulator.SimConfig()
    assert simulator._k_cap(cfg) == j_sim._k_cap(j_sim.SimConfig()) == 45
    assert (dataclasses.asdict(simulator._default_net(cfg))
            == dataclasses.asdict(j_sim._default_net(j_sim.SimConfig())))


def test_own_draws_are_seeded_and_in_range():
    cfg = simulator.SimConfig(n_services_total=64, seed=11)
    net = simulator._default_net(cfg)
    arrivals, counts = simulator._static_draws(cfg, net)
    again = simulator._static_draws(cfg, net)
    assert np.array_equal(arrivals, again[0]) and np.array_equal(counts, again[1])
    assert np.all(np.diff(arrivals) >= 0) and arrivals[0] >= 0
    assert counts.min() >= net.k_min and counts.max() <= simulator._k_cap(cfg)
    sampler = simulator.default_sampler(cfg, net, counts, CPU)
    a, b = sampler(4), sampler(4)
    assert torch.equal(a.alpha, b.alpha) and not torch.equal(a.alpha, sampler(5).alpha)
    assert torch.equal(a.client_counts(), torch.as_tensor(counts))


def test_run_scan_rejects_bad_inputs():
    cfg = simulator.SimConfig(n_services_total=3, max_periods=4)
    with pytest.raises(ValueError, match="together"):
        simulator.run_scan(cfg, arrivals=[0, 0, 0], device=CPU)
    with pytest.raises(ValueError, match="collect_history"):
        simulator.run_scan(dataclasses.replace(cfg, collect_history=False,
                                               collect_alloc=True), device=CPU)
    with pytest.raises(ValueError, match="avail"):
        simulator.run_scan(cfg, avail=np.ones((4, 3, 7), bool), device=CPU)
    with pytest.raises(ValueError, match="sampler"):
        simulator.run_scan(cfg, sampler=lambda p: simulator.default_sampler(
            simulator.SimConfig(n_services_total=2), simulator._default_net(cfg),
            [3, 3], CPU)(p), device=CPU)


def test_avail_stream_masks_clients():
    cfg = simulator.SimConfig(n_services_total=3, max_periods=6,
                              rounds_required=10 ** 6, p_arrive=0.5,
                              collect_alloc=True)
    k = simulator._k_cap(cfg)
    avail = np.ones((6, 3, k), bool)
    avail[2:, 1] = False                      # service 1 loses every client
    out = simulator.run_scan(cfg, avail=avail, device=CPU)
    h = out["history"]
    assert np.all(h["b"][2:, 1] == 0) and np.all(h["f"][2:, 1] == 0)
    assert out["durations"] == [int(x) for x in h["active"].sum(0)]


def test_only_default_scenarios_are_ported():
    assert scenarios.available("channel") == ("iid",)
    assert scenarios.available("arrival") == ("poisson",)
    assert scenarios.available("churn") == ("none",)
    for kind, name in [("channel", "gauss_markov"), ("churn", "gilbert"),
                       ("arrival", "mmpp")]:
        with pytest.raises(ValueError, match="unknown"):
            scenarios.get_process(kind, name)
