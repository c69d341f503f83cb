"""The port's live control plane (``repro_torch.fl.control_plane``)
against the JAX package's, and against its own offline engine.

Across packages the port is fed the reference's draws
(``test_torch_scenarios.jax_sampler`` on ``fold_in(key(seed + 7), p)``,
the plane putting its current client counts into them): the same
admission and heartbeat script must give the same decisions (periods,
activity and the registry exact; b rtol 1e-3 / atol 1e-4, f rtol 1e-3 /
atol 1e-5) and the same metrics.  On its own draws the port's daemon
stream must equal ``run_scan`` on its recorded trace **bitwise**
(``replay_reference``), heartbeats and all.  Checkpoints cross between
the packages: a reference snapshot restores into the port (marked
unreplayable: the port's draws do not continue the reference's stream)
and a port snapshot into the reference.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.fl import control_plane as j_cp
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import fault
from repro_torch.fl import control_plane
from repro_torch.fl.control_plane import ControlPlane, ControlPlaneConfig
from test_torch_scenarios import jax_sampler

CPU = torch.device("cpu")
FAST = dict(capacity=6, k_max=6, rounds_required=60, seed=3)
# Services that outlive a 1-period heartbeat timeout (silent "b" is dropped
# from period 2 on), and some still complete within 12 periods.
SLOW = dict(capacity=6, k_max=6, rounds_required=600, seed=3)
# Services that never complete within a test's horizon.
PERSIST = dict(capacity=6, k_max=6, rounds_required=100_000, seed=3)
SCHEDULE = {0: [("a", 4), ("b", 3)], 2: [("c", 5)], 5: [("d", 2)]}


def _channel_name(cfg) -> str:
    ch = cfg.channel_process
    return ch if isinstance(ch, str) else ch.name


def injected(cfg):
    """A port sampler serving the reference plane's draws for ``cfg``."""
    return jax_sampler(jax.random.key(cfg.seed + 7),
                       np.zeros(cfg.capacity, np.int32), cfg.capacity,
                       cfg.k_max, _channel_name(cfg))


def plane_pair(**kw):
    """(reference plane, port plane on injected draws), one config."""
    j_plane = j_cp.ControlPlane(j_cp.ControlPlaneConfig(**kw))
    cfg = ControlPlaneConfig(**kw)
    return j_plane, ControlPlane(cfg, device=CPU, sampler=injected(cfg))


def drive(plane, schedule: dict, n_periods: int,
          heartbeat_all: bool = False, silent=()):
    """Scripted synchronous serving: admissions land before the period;
    every live service heartbeats but those in ``silent``."""
    for p in range(n_periods):
        for sid, k in schedule.get(p, ()):
            plane.admit(sid, k)
        if heartbeat_all:
            for sid in list(plane.services):
                if sid not in silent:
                    plane.heartbeat(sid)
        plane.tick()
    return plane


def assert_decisions_close(got, want) -> None:
    assert len(got) == len(want)
    for d, r in zip(got, want):
        assert d.period == r.period
        assert (d.stale, d.degraded) == (r.stale, r.degraded)
        np.testing.assert_array_equal(d.active, np.asarray(r.active))
        np.testing.assert_allclose(d.b, np.asarray(r.b), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(d.f, np.asarray(r.f), rtol=1e-3, atol=1e-5)


def assert_registry_equal(plane, j_plane) -> None:
    assert plane.period == j_plane.period
    assert plane.metrics == j_plane.metrics
    assert {s: (r.slot, r.n_clients, r.admitted_period)
            for s, r in plane.services.items()} == {
        s: (r.slot, r.n_clients, r.admitted_period)
        for s, r in j_plane.services.items()}
    assert [(r.service_id, r.retired_period) for r in plane.retired] == [
        (r.service_id, r.retired_period) for r in j_plane.retired]
    for a, b in zip(plane.trace(), j_plane.trace()):
        np.testing.assert_array_equal(a, b)
    assert plane.replayable == j_plane.replayable


def assert_replays_bitwise(plane) -> None:
    assert plane.replayable, plane.unreplayable_reasons
    ref = plane.replay_reference()["history"]
    for key in ("b", "f", "active"):
        live = np.stack([getattr(d, key) for d in plane.decisions])
        np.testing.assert_array_equal(ref[key][:len(live)], live)


@pytest.mark.parametrize("channel,churn,timeout", [
    ("iid", "none", None),
    ("gauss_markov", "gilbert", None),
    ("iid", "none", 1),
])
def test_script_matches_reference(channel, churn, timeout):
    """Admissions, completion-based departures and (with a timeout) a
    silent service's heartbeat drops give the reference's decisions,
    registry and metrics."""
    kw = dict(channel_process=channel, churn_process=churn,
              heartbeat_timeout_periods=timeout,
              **(FAST if timeout is None else SLOW))
    j_plane, plane = plane_pair(**kw)
    for pl in (j_plane, plane):
        drive(pl, SCHEDULE, 12, heartbeat_all=timeout is not None,
              silent=("b",))
    assert plane.metrics["retired"] > 0
    assert (plane.metrics["heartbeat_drops"] > 0) == (timeout is not None)
    assert_decisions_close(plane.decisions, j_plane.decisions)
    assert_registry_equal(plane, j_plane)
    assert plane.recorded_avail() is None or np.array_equal(
        plane.recorded_avail(), j_plane.recorded_avail())


@pytest.mark.parametrize("channel,churn,timeout,backend", [
    ("iid", "none", None, "reference"),
    ("gauss_markov", "gilbert", None, "reference"),
    ("gauss_markov", "gilbert", None, "megakernel"),
    ("iid", "none", 1, "pallas"),
])
def test_own_stream_replays_bitwise(channel, churn, timeout, backend):
    """On its own draws the daemon's stream is ``run_scan``'s on the
    recorded trace, bit for bit: admissions, departures, heartbeat drops
    (``avail``), on every backend."""
    cfg = ControlPlaneConfig(channel_process=channel, churn_process=churn,
                             heartbeat_timeout_periods=timeout,
                             intra_backend=backend,
                             **(FAST if timeout is None else SLOW))
    plane = drive(ControlPlane(cfg, device=CPU), SCHEDULE, 12,
                  heartbeat_all=timeout is not None, silent=("b",))
    assert plane.metrics["retired"] > 0
    if timeout is not None:
        assert plane.metrics["heartbeat_drops"] > 0
        assert plane.recorded_avail() is not None
    assert_replays_bitwise(plane)


def test_healthy_heartbeats_are_a_bitwise_noop():
    base = drive(ControlPlane(ControlPlaneConfig(**FAST), device=CPU),
                 SCHEDULE, 8)
    hb = drive(ControlPlane(ControlPlaneConfig(heartbeat_timeout_periods=2,
                                               **FAST), device=CPU),
               SCHEDULE, 8, heartbeat_all=True)
    assert hb.metrics["heartbeat_drops"] == 0
    for d0, d1 in zip(base.decisions, hb.decisions):
        assert np.array_equal(d0.b, d1.b) and np.array_equal(d0.f, d1.f)


def _errors(plane):
    out = []
    for call in (lambda: plane.admit("a", 3), lambda: plane.admit("a", 2),
                 lambda: plane.admit("b", 5), lambda: plane.admit("b", 0),
                 lambda: plane.admit("b", 2), lambda: plane.admit("c", 2),
                 lambda: plane.heartbeat("ghost"),
                 lambda: plane.heartbeat("a", 7),
                 lambda: plane.retire("ghost"), lambda: plane.retire("a"),
                 lambda: plane.replay_reference()):
        try:
            call()
            out.append(None)
        except (ValueError, RuntimeError, KeyError) as exc:
            out.append((type(exc).__name__, str(exc)))
    return out


def test_admission_validation_and_slot_accounting_match_reference():
    kw = dict(capacity=2, k_max=4, rounds_required=10_000)
    j_plane, plane = plane_pair(**kw)
    got, want = _errors(plane), _errors(j_plane)
    assert got[:-1] == want[:-1]
    assert got[-1][0] == want[-1][0] == "RuntimeError"
    assert "not replayable" in got[-1][1]
    assert plane.free_slots == j_plane.free_slots == 1
    assert plane.metrics == j_plane.metrics
    assert not plane.replayable and plane.unreplayable_reasons == [
        "forced retire"]


def test_checkpoint_resume_bitwise(tmp_path):
    cfg = ControlPlaneConfig(channel_process="gauss_markov", **FAST)
    a = ControlPlane(cfg, device=CPU)
    mgr = CheckpointManager(str(tmp_path / "cp"))
    drive(a, SCHEDULE, 4)
    a.snapshot(mgr)
    tail_a = [a.tick() for _ in range(4)]
    b = ControlPlane(cfg, device=CPU)
    assert b.restore(mgr)
    assert b.period == 4 and set(b.services) == set(a.services)
    assert b.replayable
    tail_b = [b.tick() for _ in range(4)]
    for da, db in zip(tail_a, tail_b):
        assert da.period == db.period
        assert np.array_equal(da.b, db.b) and np.array_equal(da.f, db.f)


def test_run_resumable_crash_resumes_bit_identically(tmp_path):
    cfg = ControlPlaneConfig(channel_process="gauss_markov", **FAST)
    schedule = {0: (4, 3), 2: (5,)}
    policy = fault.RestartPolicy(save_every=3)
    clean, _ = control_plane.run_resumable(
        cfg, schedule, 8, CheckpointManager(str(tmp_path / "clean")), policy,
        device=CPU)
    crash_mgr = CheckpointManager(str(tmp_path / "crash"))
    with pytest.raises(RuntimeError, match="injected"):
        control_plane.run_resumable(cfg, schedule, 8, crash_mgr, policy,
                                    fail_at=5, device=CPU)
    resumed, plane = control_plane.run_resumable(cfg, schedule, 8, crash_mgr,
                                                 policy, device=CPU)
    for leaf_a, leaf_b in zip(tree.leaves(clean), tree.leaves(resumed)):
        assert torch.equal(leaf_a, leaf_b)
    assert plane.period == 8
    ref = plane.replay_reference()        # the trace survives the crash
    assert ref["history"]["b"].shape[0] == 8


def _warm_pair(tmp_path):
    kw = dict(channel_process="gauss_markov", churn_process="gilbert",
              **PERSIST)
    j_plane, plane = plane_pair(**kw)
    for pl in (j_plane, plane):
        drive(pl, SCHEDULE, 4)
    return kw, j_plane, plane


def test_reference_snapshot_restores_into_port(tmp_path):
    kw, j_plane, plane = _warm_pair(tmp_path)
    j_plane.snapshot(JManager(str(tmp_path / "ref")))
    port = ControlPlane(ControlPlaneConfig(**kw), device=CPU)
    assert port.restore(CheckpointManager(str(tmp_path / "ref")))
    assert port.period == 4
    assert set(port.services) == set(j_plane.services)
    # the carry is the reference's, leaf for leaf
    j_leaves = jax.tree.leaves(j_plane._carry)
    leaves = tree.leaves(port._carry)
    assert len(leaves) == len(j_leaves)
    for leaf, j_leaf in zip(leaves, j_leaves):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j_leaf))
    assert not port.replayable
    assert port.unreplayable_reasons == ["restored from another draw stream"]
    d = port.tick()                      # and it keeps serving
    assert np.all(np.isfinite(d.b)) and d.period == 4


def test_port_snapshot_restores_into_reference(tmp_path):
    kw, j_plane, plane = _warm_pair(tmp_path)
    plane.snapshot(CheckpointManager(str(tmp_path / "port")))
    ref = j_cp.ControlPlane(j_cp.ControlPlaneConfig(**kw))
    assert ref.restore(JManager(str(tmp_path / "port")))
    assert ref.period == 4
    assert set(ref.services) == set(plane.services)
    for leaf, j_leaf in zip(tree.leaves(plane._carry),
                            jax.tree.leaves(ref._carry)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j_leaf))
    d = ref.tick()
    assert np.all(np.isfinite(np.asarray(d.b)))
    # the port's own snapshot restores into the port as replayable
    again = ControlPlane(ControlPlaneConfig(**kw), device=CPU)
    assert again.restore(CheckpointManager(str(tmp_path / "port")))
    assert again.replayable


def test_allocation_of_and_replay_config():
    plane = ControlPlane(ControlPlaneConfig(**PERSIST), device=CPU)
    plane.admit("a", 4)
    with pytest.raises(RuntimeError, match="no decision"):
        plane.allocation_of("a")
    plane.tick()
    got = plane.allocation_of("a")
    assert got["b_mhz"] > 0 and got["stale"] is False
    with pytest.raises(KeyError):
        plane.allocation_of("ghost")
    j_plane = j_cp.ControlPlane(j_cp.ControlPlaneConfig(**PERSIST))
    j_plane.admit("a", 4)
    j_plane.tick()
    assert vars(plane.replay_sim_config()) == vars(
        j_plane.replay_sim_config())
    assert control_plane.NEVER == j_cp.NEVER
