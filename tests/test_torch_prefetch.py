"""The engine's own sampler draws the next periods ahead on host threads.

With no ``sampler`` given, ``run_scan`` and ``run_batch`` make the raw
service draws of the next periods on worker threads while the current
period runs, once a period holds ``PREFETCH_MIN_SLOTS`` (service, client)
slots.  Every period draws from its own generator, so the episodes must
be bitwise those of ``default_sampler`` called inline, period by period,
and no worker thread may outlive an episode, however it ends.  The
engine-level tests lower the threshold to 0, so small episodes prefetch.
CPU only.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import scenarios
from repro_torch.fl import simulator

CPU = torch.device("cpu")
# Small paper-like episodes: 6 services, a few periods of rounds each.
SMALL = dict(n_services_total=6, rounds_required=300, p_arrive=1.0,
             max_periods=40, collect_alloc=True)


@pytest.fixture
def prefetch_all(monkeypatch):
    monkeypatch.setattr(simulator, "PREFETCH_MIN_SLOTS", 0)


def _inline(cfg):
    net = simulator._default_net(cfg)
    _, counts = simulator._static_draws(cfg, net)
    return simulator.default_sampler(cfg, net, counts, CPU)


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in got:
        if key == "history":
            assert got[key].keys() == want[key].keys()
            for series in got[key]:
                assert np.array_equal(got[key][series], want[key][series]), \
                    series
        else:
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key


@pytest.mark.parametrize("policy,warm", [("coop", True), ("es", False),
                                         ("selfish", False)])
def test_run_scan_prefetch_equals_inline_sampler(prefetch_all, policy, warm):
    cfg = simulator.SimConfig(**SMALL, policy=policy, warm_start=warm,
                              seed=0)
    want = simulator.run_scan(cfg, sampler=_inline(cfg), device=CPU)
    got = simulator.run_scan(cfg, device=CPU)
    assert 2 < got["periods"] < cfg.max_periods
    _assert_same(got, want)


def test_run_batch_prefetch_equals_inline_samplers(prefetch_all):
    cfg = simulator.SimConfig(
        **SMALL, policy="coop", warm_start=True,
        channel_process=scenarios.spec("gauss_markov"),
        churn_process=scenarios.spec("gilbert"), arrival_process="mmpp")
    seeds = [0, 1]
    inline = [_inline(simulator.SimConfig(**{**cfg.__dict__, "seed": s}))
              for s in seeds]
    want = simulator.run_batch(cfg, seeds, samplers=inline, device=CPU)
    got = simulator.run_batch(cfg, seeds, device=CPU)
    _assert_same(got, want)


def test_seed_0_paper_episode_is_bitwise_the_inline_one(prefetch_all):
    cfg = simulator.SimConfig(policy="es", seed=0)
    want = simulator.run_scan(cfg, sampler=_inline(cfg), device=CPU)
    got = simulator.run_scan(cfg, device=CPU)
    _assert_same(got, want)


def _draw_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name.startswith("repro-draws")}


def test_an_episode_that_stops_early_leaves_no_thread(prefetch_all):
    before = _draw_threads()
    cfg = simulator.SimConfig(**{**SMALL, "max_periods": 400}, seed=0)
    out = simulator.run_scan(cfg, device=CPU)
    assert out["finished"] and out["periods"] < 100
    assert _draw_threads() == before


def test_a_failed_draw_names_its_period_and_leaves_no_thread(prefetch_all,
                                                            monkeypatch):
    before = _draw_threads()
    real = simulator._raw_draws
    seen = []

    def failing_at_3(cfg, net, counts):
        draw = real(cfg, net, counts)

        def draw_or_fail(period):
            seen.append(threading.current_thread().name)
            if period == 3:
                raise FloatingPointError("no draws today")
            return draw(period)

        return draw_or_fail

    monkeypatch.setattr(simulator, "_raw_draws", failing_at_3)
    cfg = simulator.SimConfig(**SMALL, seed=0)
    with pytest.raises(RuntimeError, match="period 3") as err:
        simulator.run_scan(cfg, device=CPU)
    assert isinstance(err.value.__cause__, FloatingPointError)
    assert seen and all(name.startswith("repro-draws") for name in seen)
    assert _draw_threads() == before


def test_a_failing_step_leaves_no_thread(prefetch_all):
    before = _draw_threads()
    from repro_torch.core import policy as policy_mod

    def broken(**options):
        def step(svc, b_total):
            raise ArithmeticError("policy down")
        return step

    factory = policy_mod._REGISTRY["es"]
    policy_mod.register("es")(broken)
    try:
        with pytest.raises(ArithmeticError, match="policy down"):
            simulator.run_scan(simulator.SimConfig(**SMALL, policy="es"),
                               device=CPU)
    finally:
        policy_mod.register("es")(factory)
    assert _draw_threads() == before


def test_prefetch_sampler_waits_and_bounds():
    cfg = simulator.SimConfig(**{**SMALL, "max_periods": 3}, seed=0)
    net = simulator._default_net(cfg)
    _, counts = simulator._static_draws(cfg, net)
    sampler = simulator._PrefetchingSampler(cfg, net, counts, CPU)
    inline = simulator.default_sampler(cfg, net, counts, CPU)
    try:
        for period in range(3):
            got, want = sampler(period), inline(period)
            for x, y in zip(got.services, want.services):
                assert (torch.equal(x, y) if torch.is_tensor(x) else x == y)
            assert (got.init is None) == (period > 0)
        # nothing is drawn past the episode's last period
        assert not sampler._pending
    finally:
        sampler.close()
    assert len(sampler.waits) == 3 and min(sampler.waits) >= 0.0
    assert 1 <= simulator.PREFETCH_WORKERS <= 6
    assert simulator.PREFETCH_DEPTH >= simulator.PREFETCH_WORKERS


def test_the_engine_prefetches_only_large_periods(monkeypatch):
    """Paper-scale periods (10 x 45 slots) draw inline; a period of
    PREFETCH_MIN_SLOTS slots or more is drawn ahead, on the threads."""
    made = []
    real = simulator._PrefetchingSampler

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(simulator, "_PrefetchingSampler", Kept)
    small = simulator.SimConfig(**{**SMALL, "max_periods": 2}, seed=0)
    simulator.run_scan(small, device=CPU)
    assert made == []
    k = simulator._k_cap(small)
    n = -(-simulator.PREFETCH_MIN_SLOTS // k)
    big = simulator.SimConfig(n_services_total=n, max_periods=2, seed=0,
                              policy="es", collect_history=False)
    simulator.run_scan(big, device=CPU)
    assert len(made) == 1 and len(made[0].waits) == 2
    assert _draw_threads() == set()
