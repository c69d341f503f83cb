"""The port's episode engine ``run_scan`` against the JAX package's.

Torch's generators cannot replay JAX's threefry stream, so the port is fed
the reference's own draws: the arrivals and client counts of
``simulator._static_draws(cfg, net)`` and, per period, the ServiceSet that
``network.sample_services(fold_in(key(cfg.seed + 7), period), ...)`` draws
inside the reference's period step (simulator.py:281-293).  Durations must
be exactly equal; per-period b and f (``collect_alloc=True``) agree to
rtol 1e-3 / atol 1e-4 and rtol 1e-3 / atol 1e-5.

Episodes with correlated scenario processes, and ``run_batch``, take the
reference's raw per-period draws and scenario draws instead
(``test_torch_scenarios.jax_sampler``), since a rebuilding channel process
builds the set from them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import network as j_network
from repro.fl import simulator as j_sim
from repro_torch import interop, scenarios
from repro_torch.core import network
from repro_torch.fl import simulator
from test_torch_scenarios import jax_sampler

CPU = torch.device("cpu")
# Small episodes: 5 services arriving about one period apart, each needing
# a few periods of rounds.
SMALL = dict(n_services_total=5, rounds_required=150, p_arrive=1.0,
             max_periods=24, seed=3, collect_alloc=True)
CASES = [("coop", False), ("coop", True), ("ec", False), ("es", False),
         ("pp", False), ("selfish", False)]


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

    def built(period):
        return network.services_from_draws(*sampler(period).services, net)[0]

    a, b = built(4), built(4)
    assert torch.equal(a.alpha, b.alpha) and not torch.equal(a.alpha, built(5).alpha)
    assert torch.equal(a.client_counts(), torch.as_tensor(counts))
    # the scenario streams are seeded per period and stream
    src4, src5 = sampler(4).source, sampler(5).source
    assert torch.equal(src4.uniform("churn", (3, 2)), src4.uniform("churn", (3, 2)))
    assert not torch.equal(src4.uniform("churn", (3, 2)), src5.uniform("churn", (3, 2)))
    assert sampler(0).init is not None and sampler(1).init is None


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
    """Every scenario process of the reference is registered now (the name
    dates from the slice that ported only the defaults); unknown names and
    parameters still raise."""
    from repro import scenarios as j_scenarios

    for kind in scenarios.KINDS:
        assert scenarios.available(kind) == j_scenarios.available(kind)
    assert scenarios.available("channel") == ("gauss_markov", "iid",
                                              "rayleigh_block")
    for kind, name in [("channel", "ar2"), ("churn", "markov3"),
                       ("arrival", "hawkes")]:
        with pytest.raises(ValueError, match="unknown"):
            scenarios.get_process(kind, name)
    with pytest.raises(ValueError, match="unknown parameter"):
        scenarios.get_churn(scenarios.spec("gilbert", p_dorp=0.1), None)


# ---------------------------------------------------------------------------
# Correlated scenario processes and run_batch, on the reference's draws.
# ---------------------------------------------------------------------------

SCENARIO_CASES = [
    dict(channel_process=scenarios.spec("gauss_markov", rho=0.9),
         churn_process=scenarios.spec("gilbert", p_drop=0.2, p_return=0.4,
                                      always_keep=1),
         arrival_process="mmpp", policy="coop", warm_start=True),
    dict(channel_process=scenarios.spec("rayleigh_block", rho=0.8,
                                        shadowing_rho=0.9),
         churn_process="bernoulli", arrival_process="batched",
         policy="selfish"),
    dict(channel_process="rayleigh_block", churn_process="none",
         arrival_process="periodic", policy="es"),
]


def _j_spec(sp):
    from repro import scenarios as j_scenarios

    if isinstance(sp, str):
        return sp
    return j_scenarios.spec(sp.name, **sp.kwargs())


def _j_cfg(**opts):
    opts = dict(opts)
    for key in ("channel_process", "churn_process", "arrival_process"):
        if key in opts:
            opts[key] = _j_spec(opts[key])
    return j_sim.SimConfig(**opts)


def _channel_name(opts):
    sp = opts.get("channel_process", "iid")
    return sp if isinstance(sp, str) else sp.name


@pytest.mark.parametrize("opts", SCENARIO_CASES,
                         ids=["gauss_markov-gilbert-mmpp-coop_warm",
                              "rayleigh_shadow-bernoulli-batched-selfish",
                              "rayleigh-periodic-es"])
def test_run_scan_with_scenarios_matches_reference(opts):
    opts = dict(SMALL, **opts)
    ref = j_sim.run_scan(_j_cfg(**opts))
    j_cfg = _j_cfg(**opts)
    arrivals, counts = j_sim._static_draws(j_cfg, j_sim._default_net(j_cfg))
    k = j_sim._k_cap(j_cfg)
    sampler = jax_sampler(jax.random.key(opts["seed"] + 7), counts,
                          opts["n_services_total"], k, _channel_name(opts))
    got = simulator.run_scan(simulator.SimConfig(**opts), arrivals=arrivals,
                             counts=counts, sampler=sampler, device=CPU)
    assert got["durations"] == ref["durations"]
    assert got["periods"] == ref["periods"]
    assert got["finished"] == ref["finished"] and got["fallbacks"] == 0
    h, rh = got["history"], ref["history"]
    assert np.array_equal(h["rounds"], rh["rounds"])
    assert np.array_equal(h["n_clients"], rh["n_clients"])
    np.testing.assert_allclose(h["b"], rh["b"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h["f"], rh["f"], rtol=1e-3, atol=1e-5)


def test_rebuilding_channel_needs_raw_draws(reference_draws):
    arrivals, counts, sets = reference_draws
    cfg = simulator.SimConfig(**dict(SMALL, channel_process="gauss_markov"))
    with pytest.raises(ValueError, match="raw draws"):
        simulator.run_scan(cfg, arrivals=arrivals, counts=counts,
                           sampler=_sampler(sets), device=CPU)


BATCH = dict(SMALL, max_periods=30, policy="coop", warm_start=True,
             channel_process=scenarios.spec("gauss_markov", rho=0.9),
             churn_process=scenarios.spec("gilbert", p_drop=0.1,
                                          p_return=0.5),
             arrival_process="mmpp")
SEEDS = [3, 8]


def _batch_inputs(opts):
    j_cfg = _j_cfg(**opts)
    arrivals, counts = j_sim._static_draws_batch(
        j_cfg, j_sim._default_net(j_cfg), SEEDS)
    k = j_sim._k_cap(j_cfg)
    samplers = [jax_sampler(jax.random.key(s + 7), counts[i],
                            opts["n_services_total"], k, _channel_name(opts))
                for i, s in enumerate(SEEDS)]
    return j_cfg, arrivals, counts, samplers


@pytest.mark.parametrize("collect_history", [True, False])
def test_run_batch_matches_reference(collect_history):
    opts = dict(BATCH, collect_history=collect_history,
                collect_alloc=collect_history)
    j_cfg, arrivals, counts, samplers = _batch_inputs(opts)
    ref = j_sim.run_batch(j_cfg, SEEDS)
    got = simulator.run_batch(simulator.SimConfig(**opts), SEEDS,
                              arrivals=arrivals, counts=counts,
                              samplers=samplers, device=CPU)
    assert set(got) - set(ref) == {"fallbacks"}
    assert not np.any(got["fallbacks"])
    assert got["seeds"] == ref["seeds"]
    for key in ("durations", "finished", "avg_duration", "std_duration"):
        assert got[key].dtype == ref[key].dtype, key
        assert np.array_equal(got[key], ref[key]), key
    if not collect_history:
        assert got["history"] is None and ref["history"] is None
        assert got["periods"].dtype == ref["periods"].dtype
        assert np.array_equal(got["periods"], ref["periods"])
        for key, val in ref["totals"].items():
            assert got["totals"][key].dtype == val.dtype, key
            np.testing.assert_allclose(got["totals"][key], val, rtol=1e-4)
        return
    h, rh = got["history"], ref["history"]
    assert set(h) == set(rh)
    for key, val in rh.items():
        val = np.asarray(val)
        assert h[key].shape == val.shape and h[key].dtype == val.dtype, key
        if val.dtype == np.float32:
            atol = 1e-4 if key == "b" else 1e-5
            np.testing.assert_allclose(h[key], val, rtol=1e-3, atol=atol)
        else:
            assert np.array_equal(h[key], val), key
    # some episode stopped early, and the reference's scan shows what the
    # padded periods hold: nothing active, nothing allocated, all done
    done = np.asarray(rh["all_done"])
    assert done.any() and not done.all()


def test_run_batch_rejects_bad_inputs():
    cfg = simulator.SimConfig(n_services_total=3, max_periods=4)
    with pytest.raises(ValueError, match="at least one seed"):
        simulator.run_batch(cfg, [], device=CPU)
    with pytest.raises(ValueError, match="together"):
        simulator.run_batch(cfg, [0], arrivals=[[0, 0, 0]], device=CPU)
    with pytest.raises(ValueError, match="samplers"):
        simulator.run_batch(cfg, [0, 1], samplers=[None], device=CPU)
    with pytest.raises(ValueError, match="seeds, n_services_total"):
        simulator.run_batch(cfg, [0, 1], arrivals=np.zeros((1, 3)),
                            counts=np.zeros((1, 3)), device=CPU)
    out = simulator.run_batch(cfg, [0, 1], device=CPU)
    assert out["durations"].shape == (2, 3)
    assert out["history"]["all_done"].shape == (2, 4)
    single = simulator.run_scan(dataclasses.replace(cfg, seed=1), device=CPU)
    assert out["durations"][1].tolist() == single["durations"]
