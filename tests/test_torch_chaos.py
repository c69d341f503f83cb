"""The port's chaos drills (``repro_torch.chaos``) against the JAX
package's.

The schedule is numpy in both packages, so its draws are compared bit for
bit.  Storms run at ``benchmarks/bench_fault.py --tiny``'s size
(capacities 4 and 8, 14 periods, ``k_max`` 8, gauss_markov channels,
heartbeat timeout 2) with the port fed the reference's period draws
(``test_torch_control_plane.injected``): per injector family, and for the
full catalogue, the event trajectory (poison picks included) and every
counter must equal the reference's, and the invariants must hold in both.
On the port's own draws: the same seed gives the same digest, a healthy
storm's replay check runs and is bitwise, and a poisoned carry is rescued
on every backend as on ``"reference"`` (decisions within the
control-plane tests' tolerances), and clients with zero load (a
whole row, and each row's slowest client) count as clients on every
backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import engine as j_engine
from repro.chaos import injectors as j_inj
from repro.chaos.schedule import ChaosSchedule as JSchedule
from repro.core import disba as j_disba
from repro.core import network as j_network
from repro.core import policy as j_policy
from repro.core import types as j_types
from repro.fl import control_plane as j_cp
from repro_torch import chaos, interop, tree
from repro_torch.chaos import injectors, invariants
from repro_torch.chaos.schedule import ChaosSchedule
from repro_torch.core import disba, policy
from repro_torch.fl.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.launch import allocd
from test_torch_control_plane import (CPU, assert_decisions_close,
                                      injected, plane_pair)

TINY = dict(k_max=8, policy="coop", warm_start=True, rounds_required=250,
            channel_process="gauss_markov", heartbeat_timeout_periods=2,
            seed=0)
PERIODS, SEED, SAVE_EVERY = 14, 42, 3


def test_schedule_draws_equal_reference():
    for seed in (0, 7, 2 ** 40 + 3):
        a, b = ChaosSchedule(seed), JSchedule(seed)
        assert a.seed == b.seed
        for period in (0, 3, 11, 2 ** 33):
            for channel in ("solver", "hb/svc-1-0", "admission", "byz/2",
                            "bid"):
                assert np.array_equal(a.rng(period, channel).random(6),
                                      b.rng(period, channel).random(6))
                assert a.fires(period, channel, 0.4) == b.fires(
                    period, channel, 0.4)


def _family(mod, name, k_max):
    base = [mod.AdmissionChaos(k_max, p_admit=0.5)]
    if name == "heartbeat":
        return base + [mod.HeartbeatChaos(p_drop=0.2, p_flap=0.1)]
    if name == "solver":
        return base + [mod.SolverChaos(p_deadline=0.2, p_poison_chan=0.3,
                                       p_poison_seed=0.2)]
    if name == "checkpoint":
        return base + [mod.CheckpointChaos(p_torn=0.1, p_truncate=0.1,
                                           p_corrupt=0.1, p_restart=0.15)]
    if name == "all":
        return None
    return base


def _storm_pair(tmp_path, capacity, family, backend="reference"):
    kw = dict(capacity=capacity, **TINY)
    ckpt = family in ("checkpoint", "all")
    want = j_engine.run_storm(
        j_cp.ControlPlaneConfig(**kw), seed=SEED, n_periods=PERIODS,
        injectors=_family(j_inj, family, TINY["k_max"]),
        checkpoint_dir=str(tmp_path / "j") if ckpt else None,
        save_every=SAVE_EVERY)
    cfg = ControlPlaneConfig(**kw, intra_backend=backend)
    got = chaos.run_storm(
        cfg, seed=SEED, n_periods=PERIODS,
        injectors=_family(injectors, family, TINY["k_max"]),
        checkpoint_dir=str(tmp_path / "t") if ckpt else None,
        save_every=SAVE_EVERY, device=CPU, sampler=injected(cfg))
    return got, want


def _assert_storms_match(got, want) -> None:
    assert got["events"] == want["events"]
    for key in ("metrics", "served", "restarts", "rejections",
                "decisions_lost", "recovery", "n_events"):
        assert got[key] == want[key], key
    for name, res in got["invariants"].items():
        assert res["ok"], (name, res)
        assert want["invariants"][name]["ok"]


@pytest.mark.parametrize("family", ["admission", "heartbeat", "solver",
                                    "checkpoint"])
def test_injector_family_matches_reference(tmp_path, family):
    got, want = _storm_pair(tmp_path, 4, family)
    _assert_storms_match(got, want)
    if family == "solver":
        actions = {e["action"] for e in got["events"]}
        assert {"poison_channel", "poison_warm_seed"} <= actions
        assert got["metrics"]["solver_fallbacks"] > 0
    if family == "checkpoint":
        assert got["restarts"] > 0


@pytest.mark.parametrize("capacity,backend", [(4, "megakernel"),
                                              (8, "reference"),
                                              (8, "pallas")])
def test_full_storm_matches_reference(tmp_path, capacity, backend):
    got, want = _storm_pair(tmp_path, capacity, "all", backend)
    _assert_storms_match(got, want)


def test_same_seed_same_digest(tmp_path):
    cfg = ControlPlaneConfig(capacity=4, **TINY)

    def storm(tag, seed):
        return chaos.run_storm(cfg, seed=seed, n_periods=PERIODS,
                               checkpoint_dir=str(tmp_path / tag),
                               save_every=SAVE_EVERY, device=CPU)

    r1, r2, r3 = storm("a", SEED), storm("b", SEED), storm("c", SEED + 1)
    assert r1["digest"] == r2["digest"] and r1["events"] == r2["events"]
    assert r1["metrics"] == r2["metrics"]
    assert r3["digest"] != r1["digest"]
    for r in (r1, r3):
        assert all(v["ok"] for v in r["invariants"].values())


class _Workload(injectors.Injector):
    name = "workload"

    def pre(self, engine, period):
        if period in (0, 2) and engine.daemon.plane.free_slots:
            engine.daemon.submit(allocd.Admit(f"w{period}", 3))
            return [{"action": "admit", "service": f"w{period}"}]
        return []


def test_healthy_storm_replay_invariant_is_bitwise():
    """With scripted admissions only the plane stays replayable, and the
    invariant's differential replay against run_scan runs and holds."""
    cfg = ControlPlaneConfig(capacity=4, k_max=4, rounds_required=300)
    report = chaos.run_storm(cfg, seed=1, n_periods=10,
                             injectors=[_Workload()], device=CPU)
    replay = report["invariants"]["replay"]
    assert replay["ok"] and not replay["skipped"] and replay["checked"] == 10
    assert report["served"]["fresh"] == 10


def test_assert_invariants_raises_on_violation():
    plane = ControlPlane(ControlPlaneConfig(capacity=2, k_max=4,
                                            rounds_required=5000), device=CPU)
    plane.admit("a", 2)
    d = plane.tick()
    invariants.assert_invariants([d], plane)
    forged = d._replace(b=np.full_like(d.b, 1e9))
    with pytest.raises(AssertionError, match="budget"):
        invariants.assert_invariants([forged], plane)
    forged = d._replace(f=np.full_like(d.f, np.nan))
    with pytest.raises(AssertionError, match="finite"):
        invariants.assert_invariants([forged], plane)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poison_picks_equal_reference(seed):
    """The leaf, element and value a poisoning picks (and where the NaN or
    Inf lands in the carry) equal the reference's; so does the warm
    seed's."""
    j_plane, plane = plane_pair(capacity=4, k_max=8, rounds_required=5000,
                                channel_process="gauss_markov",
                                churn_process="gilbert")
    for pl in (j_plane, plane):
        pl.admit("a", 8)
        pl.tick()
    got = injectors.poison_channel_state(plane, np.random.default_rng(seed))
    want = j_inj.poison_channel_state(j_plane, np.random.default_rng(seed))
    assert got == want and got is not None
    for leaf, j_leaf in zip(tree.leaves(plane._carry[2]),
                            j_plane._carry[2]):
        np.testing.assert_array_equal(np.isfinite(leaf.numpy()),
                                      np.isfinite(np.asarray(j_leaf)))
    assert injectors.poison_warm_seed(
        plane, np.random.default_rng(seed)) == j_inj.poison_warm_seed(
        j_plane, np.random.default_rng(seed))


@pytest.mark.parametrize("poison", ["channel", "seed"])
def test_poisoned_tick_rescued_on_every_backend(poison, monkeypatch):
    """The same poisoned carry on every backend (the kernels' plain
    versions here; the card in ``chip_smoke.py``) and in the reference
    package: the same rescue count, finite decisions, the carry healed,
    and the next tick finite and within tolerance of the reference
    plane's.  A poisoned channel entry poisons one client of a service:
    the port's rescue drops that client, so its decision is the JAX
    package's cold bisection of the tick's set without the poisoned
    clients (``mask_clients``); the JAX plane's own rescue keeps 1.0 in
    the dropped slot and meets C2.  A poisoned seed leaves the set whole,
    and every backend's decisions stay within tolerance of each other."""
    solves = []
    solve = disba.solve_lambda_newton_warm

    def recording(svc, b_total, *args, **kwargs):
        solves.append((svc, b_total))
        return solve(svc, b_total, *args, **kwargs)

    monkeypatch.setattr(disba, "solve_lambda_newton_warm", recording)
    out = {}
    for backend in ("reference", "pallas", "megakernel", "jax"):
        kw = dict(capacity=4, k_max=8, rounds_required=5000,
                  channel_process="gauss_markov")
        j_plane, plane = plane_pair(
            **kw, intra_backend="reference" if backend == "jax"
            else backend)
        pl = j_plane if backend == "jax" else plane
        mod = j_inj if backend == "jax" else injectors
        for i in range(4):
            pl.admit(f"s{i}", 8)
        pl.tick()
        rng = np.random.default_rng(5)
        ev = (mod.poison_channel_state(pl, rng) if poison == "channel"
              else mod.poison_warm_seed(pl, rng, value=np.nan))
        assert ev is not None
        d = pl.tick()
        poisoned_set = solves[-1] if backend != "jax" else None
        d2 = pl.tick()
        out[backend] = (d, d2, dict(pl.metrics), poisoned_set)
        assert not pl.replayable and pl.unreplayable_reasons
    ref = out["reference"]
    for backend, (d, d2, metrics, poisoned_set) in out.items():
        assert metrics == ref[2], backend
        assert metrics["solver_fallbacks"] >= 1
        assert np.all(np.isfinite(d.b)) and np.all(np.isfinite(d2.f))
        if poison == "seed":
            assert_decisions_close([d, d2], ref[:2])
            continue
        assert_decisions_close([d2], [out["jax"][1]])
        if backend == "jax":
            continue
        svc, b_total = poisoned_set
        alpha, t_comp = svc.alpha.numpy(), svc.t_comp.numpy()
        finite = np.isfinite(alpha) & np.isfinite(t_comp)
        assert not finite[svc.mask.numpy()].all()   # a client was poisoned
        dropped = j_types.mask_clients(
            j_types.ServiceSet(alpha=jnp.asarray(alpha),
                               t_comp=jnp.asarray(t_comp),
                               mask=jnp.asarray(svc.mask.numpy())),
            jnp.asarray(finite))
        want = j_disba.solve_lambda_bisect(dropped, b_total)
        assert_decisions_close([d], [d._replace(b=want.b, f=want.f)])


needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _no_load_services(rows: str):
    """Four sampled services where clients carry no transmission load
    (alpha = 0: an infinite rate, which a path loss poisoned to -inf dB
    gives): service 0 wholly (``rows`` "all"), or in every service the
    slowest client, its t^C raised 50-fold so that it alone sets the
    row's max t^C and the round time (``rows`` "slowest")."""
    j_svc, _ = j_network.sample_services(jax.random.key(0), 4, k_max=6)
    alpha, t_comp = np.array(j_svc.alpha), np.array(j_svc.t_comp)
    mask = np.asarray(j_svc.mask)
    if rows == "all":
        alpha[0] = 0.0
    else:
        for n in range(alpha.shape[0]):
            k = int(np.argmax(np.where(mask[n], t_comp[n], -np.inf)))
            alpha[n, k] = 0.0
            t_comp[n, k] *= 50.0
    return j_svc._replace(alpha=jnp.asarray(alpha),
                          t_comp=jnp.asarray(t_comp))


def _zero_load_cases():
    """(policy, rows, device) for every policy on both row kinds, on the
    CPU and the card; the whole-row CPU cases of ``es`` and ``pp`` keep
    their first ids."""
    for device in ("cpu", "cuda"):
        for rows in ("all", "slowest"):
            for name in ("es", "pp", "coop", "coop-warm", "selfish"):
                first = device == "cpu" and rows == "all" and name in (
                    "es", "pp")
                yield pytest.param(
                    name, rows, device,
                    id=name if first else f"{name}-{rows}-{device}",
                    marks=needs_cuda if device == "cuda" else ())


@pytest.mark.parametrize("name,rows,device", list(_zero_load_cases()))
def test_zero_load_row_on_the_kernel_backends(name, rows, device):
    """Clients with alpha = 0 stay clients: every backend takes a row's
    clients from the service set's mask, so such a client's t^C counts in
    max t^C (and bounds the round time) on the kernel backends as on
    "reference", a whole row of them included: b and f equal the
    reference package's "reference" backend's (its kernel backend takes
    alpha > 0 as a client's mark and gives a zero-load row f = 1e30;
    ROADMAP C7).  On the CPU the kernels' plain versions run; on the card
    B1-B4 themselves."""
    j_svc = _no_load_services(rows)
    warm = name == "coop-warm"
    policy_name = "coop" if warm else name
    j_pol = j_policy.get_stateful_policy(policy_name, warm_start=warm)
    want_b, want_f, _ = j_pol.step(j_svc, 10.0, j_pol.init_state(4))
    want_b, want_f = np.asarray(want_b), np.asarray(want_f)
    assert np.all(np.isfinite(want_f)) and np.all(want_f < 1e3)
    with np.errstate(divide="ignore"):
        want_t = 1.0 / want_f            # +inf where a row gets no band
    svc = interop.service_set_from_arrays(
        *(np.asarray(x) for x in j_svc), device=torch.device(device))
    for backend in ("reference", "pallas", "megakernel"):
        pol = policy.get_stateful_policy(policy_name, warm_start=warm,
                                         intra_backend=backend)
        b, f, _ = pol.step(svc, 10.0, pol.init_state(4, device=svc.device))
        np.testing.assert_allclose(b.cpu().numpy(), want_b, rtol=1e-3,
                                   atol=1e-4, err_msg=backend)
        np.testing.assert_allclose(f.cpu().numpy(), want_f, rtol=1e-3,
                                   atol=1e-5, err_msg=backend)
        t = policy.round_time_fn(backend)(svc, b)
        np.testing.assert_allclose(t.cpu().numpy(), want_t, rtol=1e-5,
                                   err_msg=backend)
