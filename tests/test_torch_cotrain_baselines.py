"""The port's co-trained episode against the JAX package's for the
``pp`` and ``ec`` baselines, under correlated scenario processes (warm
``coop`` with Gauss-Markov shadowing and Bernoulli churn, the reference's
scenario draws injected through ``jax_sampler``), and at the
all-straggler limit.  The
reference's draws, batches and initial tables are injected and the
tolerances are those of ``tests/test_torch_cotrain.py``, whose helpers
this file uses.
"""
import dataclasses

import numpy as np
import pytest

from repro import scenarios as j_scenarios
from repro_torch import scenarios
from repro_torch.fl import cotrain, simulator
from test_torch_cotrain import (CPU, NET, assert_matches, ref_inputs,
                                reference)


@pytest.mark.parametrize("policy", ["pp", "ec"])
def test_cotrain_baselines_match_reference(policy):
    j_cfg, cfg, j_train, train, inject = ref_inputs(dict(policy=policy), {})
    ref = reference(j_cfg, j_train)
    assert ref["clipped_rounds"] > 0      # rounds_cap 2 clips
    got = cotrain.run_cotrain_scan(cfg, train, NET, **inject)
    assert_matches(got, ref, train)


def test_cotrain_scenario_stack_matches_reference():
    opts = dict(policy="coop", warm_start=True,
                channel_process=scenarios.spec("gauss_markov", rho=0.9),
                churn_process=scenarios.spec("bernoulli", p_drop=0.1))
    j_cfg, cfg, j_train, train, inject = ref_inputs(opts, dict(rounds_cap=3))
    j_cfg = dataclasses.replace(
        j_cfg, channel_process=j_scenarios.spec("gauss_markov", rho=0.9),
        churn_process=j_scenarios.spec("bernoulli", p_drop=0.1))
    ref = reference(j_cfg, j_train)
    got = cotrain.run_cotrain_scan(cfg, train, NET, **inject)
    assert_matches(got, ref, train)
    assert got["history"]["participants"].max() > 0


def test_all_stragglers_freeze_learning_not_allocation():
    """deadline_x < 1 drops every client: the tables stay at their init
    bitwise, the allocation stream is the plain engine's."""
    j_cfg, cfg, j_train, train, inject = ref_inputs(
        dict(policy="pp"), dict(deadline_x=1e-3))
    ref = reference(j_cfg, j_train)
    got = cotrain.run_cotrain_scan(cfg, train, NET, **inject)
    assert_matches(got, ref, train)
    assert int(got["history"]["participants"].sum()) == 0
    assert sum(got["trained_rounds"]) > 0
    np.testing.assert_array_equal(got["params"], inject["init_params"])
    plain = simulator.run_scan(cfg, NET, arrivals=inject["arrivals"],
                               counts=inject["counts"],
                               sampler=inject["sampler"], device=CPU)
    assert got["durations"] == plain["durations"]


