"""The port's co-trained episode against the JAX package's, with the
training options: compression (top-k with error feedback, per-service
levels, the adaptive switch) and robust aggregators.  The reference's
draws, batches and initial tables are injected and the tolerances are
those of ``tests/test_torch_cotrain.py``, whose helpers this file uses.
"""
import numpy as np
import pytest

from repro_torch.fl import cotrain
from test_torch_cotrain import NET, assert_matches, ref_inputs, reference

FEATURE_CASES = {
    "topk_error_feedback": (dict(policy="es"),
                            dict(compression="topk", topk_frac=0.25,
                                 error_feedback=True)),
    "comp_levels": (dict(policy="es"),
                    dict(comp_levels=("none", "topk", "int8"),
                         topk_frac=0.05, index_bits=16)),
    "adaptive": (dict(policy="pp"),
                 dict(compression="topk", topk_frac=0.05, index_bits=16,
                      comp_policy="adaptive", comp_threshold=1.5)),
    "trimmed_mean": (dict(policy="coop", warm_start=True),
                     dict(aggregator="trimmed_mean", trim_frac=0.2)),
    "krum": (dict(policy="es"), dict(aggregator="krum")),
}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_cotrain_features_match_reference(case):
    opts, train_kw = FEATURE_CASES[case]
    j_cfg, cfg, j_train, train, inject = ref_inputs(opts, train_kw)
    ref = reference(j_cfg, j_train)
    got = cotrain.run_cotrain_scan(cfg, train, NET, **inject)
    assert_matches(got, ref, train)
    if case == "adaptive":
        assert np.asarray(ref["history"]["comp_id"]).max() == 1
    if case == "comp_levels":
        np.testing.assert_allclose(got["history"]["ul_mult"][:, 1], 0.075)
