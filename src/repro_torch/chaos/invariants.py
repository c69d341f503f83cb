"""Safety invariants every chaos storm must preserve.

``verify`` checks the served decision stream (fresh, stale, and degraded
alike) and the surviving plane against the properties no injected fault is
allowed to break:

* **budget**        no served allocation exceeds the provider's bandwidth
                    budget (beyond float32 tolerance);
* **finite**        no non-finite bandwidth or frequency is ever served
                    (the non-finite catch must have degraded instead);
* **inactive_zero** slots flagged inactive in a decision receive nothing;
* **occupancy**     bandwidth only ever goes to slots that were occupied in
                    the registry when the decision was served (retired
                    slots are never allocated);
* **replay**        when the plane still claims ``replayable``, its
                    fresh-solve stream matches the port's own
                    ``simulator.run_scan`` on the recorded trace **bitwise**
                    (decisions aligned by period, so a post-restart partial
                    stream still checks).

Each entry of the returned dict is ``{"ok": bool, ...detail}``;
``assert_invariants`` raises on the first violation with the full report.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree

# Absolute/relative slack for float32 budget sums.
_BUDGET_RTOL = 1e-5
_BUDGET_ATOL = 1e-6


def verify(served, plane, occupancy: list[list[int]] | None = None) -> dict:
    """Check every invariant; never raises (``assert_invariants`` does).
    ``occupancy`` is the engine's per-wall-period record of occupied slots,
    indexed like ``served``."""
    out: dict[str, dict] = {}
    budget = plane.net.total_bandwidth_mhz
    bound = budget * (1.0 + _BUDGET_RTOL) + _BUDGET_ATOL

    bad_budget = []
    bad_finite = []
    bad_inactive = []
    for i, d in enumerate(served):
        b = np.asarray(d.b, np.float64)
        f = np.asarray(d.f, np.float64)
        active = np.asarray(d.active, bool)
        if float(b.sum()) > bound:
            bad_budget.append({"index": i, "period": int(d.period),
                               "sum_mhz": float(b.sum())})
        if not (np.all(np.isfinite(b)) and np.all(np.isfinite(f))):
            bad_finite.append({"index": i, "period": int(d.period)})
        if np.any(b[~active] != 0.0) or np.any(f[~active] != 0.0):
            bad_inactive.append({"index": i, "period": int(d.period)})
    out["budget"] = {"ok": not bad_budget, "budget_mhz": float(budget),
                     "violations": bad_budget[:5]}
    out["finite"] = {"ok": not bad_finite, "violations": bad_finite[:5]}
    out["inactive_zero"] = {"ok": not bad_inactive,
                            "violations": bad_inactive[:5]}

    if occupancy is not None:
        bad_occ = []
        for i, d in enumerate(served[:len(occupancy)]):
            allowed = set(occupancy[i])
            getting = set(int(s) for s in np.flatnonzero(
                np.asarray(d.b, np.float64) > 0.0))
            stray = sorted(getting - allowed)
            if stray:
                bad_occ.append({"index": i, "period": int(d.period),
                                "slots": stray})
        out["occupancy"] = {"ok": not bad_occ, "violations": bad_occ[:5]}

    out["replay"] = _check_replay(plane)
    return out


def _check_replay(plane) -> dict:
    """Bitwise differential replay of the plane's fresh-solve stream
    against ``run_scan`` on the recorded trace, on the plane's device.
    Only meaningful while the plane claims ``replayable``: every injected
    fault falsifies that flag with a recorded reason, which is itself part
    of the contract, so a non-replayable plane passes this check iff it
    has at least one recorded reason."""
    if not plane.replayable:
        reasons = list(plane.unreplayable_reasons)
        return {"ok": bool(reasons), "skipped": True, "reasons": reasons}
    if not plane.decisions:
        return {"ok": True, "skipped": True, "reasons": ["no fresh decision"]}
    ref = plane.replay_reference()
    b_ref = np.asarray(ref["history"]["b"])
    f_ref = np.asarray(ref["history"]["f"])
    mismatches = []
    checked = 0
    for d in plane.decisions:
        if d.period >= b_ref.shape[0]:
            continue
        checked += 1
        if not (np.array_equal(np.asarray(d.b), b_ref[d.period])
                and np.array_equal(np.asarray(d.f), f_ref[d.period])):
            mismatches.append(int(d.period))
    return {"ok": not mismatches, "skipped": False, "checked": checked,
            "mismatch_periods": mismatches[:10]}


def assert_invariants(served, plane,
                      occupancy: list[list[int]] | None = None) -> dict:
    """``verify`` + raise AssertionError naming every violated invariant."""
    report = verify(served, plane, occupancy=occupancy)
    bad = [name for name, res in report.items() if not res["ok"]]
    if bad:
        raise AssertionError(
            f"chaos invariants violated: {bad}; report={report}")
    return report


# ---------------------------------------------------------------------------
# Robustness gates: what an *adversarial-participant* storm must preserve.
# ---------------------------------------------------------------------------

# Max final-accuracy drop a robust aggregator may concede to a byz_frac<=0.2
# sign-flip/scaled-delta cohort on the bigram task (absolute, on [0, 1]).
ROBUST_ACC_DROP = 0.15


def accuracy_bounded(clean_acc: float, attacked_acc: float,
                     max_drop: float = ROBUST_ACC_DROP) -> dict:
    """Bounded breakdown: under f Byzantine clients a *robust* aggregator's
    final accuracy must stay within ``max_drop`` of the clean run's."""
    drop = float(clean_acc) - float(attacked_acc)
    return {"ok": bool(np.isfinite(attacked_acc) and drop <= max_drop),
            "clean_acc": float(clean_acc),
            "attacked_acc": float(attacked_acc),
            "drop": drop, "max_drop": float(max_drop)}


def params_finite(params) -> dict:
    """Unconditional: no aggregator run may ever serve non-finite model
    parameters (tensors or arrays at the leaves): a NaN/Inf update must be
    masked, trimmed, or out-scored, never averaged in."""
    bad = [i for i, leaf in enumerate(tree.leaves(params))
           if not bool(torch.all(torch.isfinite(torch.as_tensor(leaf))))]
    return {"ok": not bad, "nonfinite_leaves": bad[:5]}


def regret_bounded(rows: list[dict], tol: float = 1e-3) -> dict:
    """Prop. 5 gate: no audited bid deviation may gain more than the Eq. 31
    truthfulness gap (``auction.delta_bound``) plus float tolerance."""
    bad = [r for r in rows
           if r["gain"] > r["delta_bound"] + tol
           or not np.isfinite(r["gain"])]
    worst = max((r["gain"] - r["delta_bound"] for r in rows), default=0.0)
    return {"ok": not bad, "n_audited": len(rows),
            "worst_excess": float(worst),
            "violations": [{k: v for k, v in r.items()
                            if k in ("trial", "provider", "deviation",
                                     "factor", "gain", "delta_bound")}
                           for r in bad[:5]]}


def assert_robust(report: dict) -> dict:
    """Raise on the first failed robustness gate (same shape contract as
    ``assert_invariants``: a dict of ``{"ok": bool, ...}`` entries)."""
    bad = [name for name, res in report.items() if not res["ok"]]
    if bad:
        raise AssertionError(
            f"robustness gates violated: {bad}; report={report}")
    return report
