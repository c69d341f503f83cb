"""The port's allocation daemon (``repro_torch.launch.allocd``) against the
JAX package's, and its degradation paths.

The same request stream (admissions with capacity overflow, a duplicate
id, a bad cohort size, a ghost heartbeat, a forced retire) through both
daemons, the port's on the reference's draws, must give equal registries,
rejections and metrics, and decisions within the control-plane tests'
tolerances.  Then the port alone: a deadline miss serves a counted stale
decision while the solve still commits; an error raised by the solve
propagates (it is never turned into a stale decision); capacity
rejections retry with bounded backoff; a restarted daemon resumes from
its checkpoint; the CLI's replay check is bitwise; and B3's mailbox
tags, handed out from many threads, never overlap.
"""
import asyncio
import sys
import threading

import numpy as np
import pytest
import torch

from repro.fl import control_plane as j_cp
from repro.launch import allocd as j_allocd
from repro_torch.checkpoint import CheckpointManager
from repro_torch.fl.control_plane import ControlPlaneConfig
from repro_torch.kernels import market_clear
from repro_torch.launch import allocd
from test_torch_control_plane import (CPU, PERSIST, assert_decisions_close,
                                      assert_registry_equal, injected)


def _requests(mod):
    return {0: [mod.Admit("a", 4), mod.Admit("b", 3), mod.Admit("c", 2),
                mod.Admit("a", 2), mod.Admit("x", 9), mod.Admit("f", 3),
                mod.Heartbeat("ghost")],
            2: [mod.Retire("b"), mod.Admit("d", 5)],
            3: [mod.Heartbeat("a", 1), mod.Admit("e", 3)],
            5: [mod.Retire("nope")]}


async def _serve(daemon, requests, n_periods):
    for p in range(n_periods):
        for req in requests.get(p, ()):
            daemon.submit(req)
        await daemon.step_period()
    await daemon.close()


def test_request_stream_matches_reference():
    kw = dict(capacity=3, k_max=6, rounds_required=600, seed=5,
              channel_process="gauss_markov", heartbeat_timeout_periods=2)
    j_daemon = j_allocd.AllocDaemon(j_cp.ControlPlaneConfig(**kw),
                                    admit_max_retries=2)
    cfg = ControlPlaneConfig(**kw)
    daemon = allocd.AllocDaemon(cfg, admit_max_retries=2, device=CPU,
                                sampler=injected(cfg))
    asyncio.run(_serve(j_daemon, _requests(j_allocd), 10))
    asyncio.run(_serve(daemon, _requests(allocd), 10))
    assert daemon.rejections == j_daemon.rejections
    assert len(daemon.rejections) >= 4
    assert daemon.plane.metrics["admit_retries"] > 0
    assert "f" in set(daemon.plane.services) | {
        r.service_id for r in daemon.plane.retired}     # landed on retry
    assert_registry_equal(daemon.plane, j_daemon.plane)
    assert_decisions_close(daemon.served, j_daemon.served)
    assert_decisions_close(daemon.plane.decisions, j_daemon.plane.decisions)


def test_stale_decision_on_deadline_miss():
    daemon = allocd.AllocDaemon(ControlPlaneConfig(**PERSIST), device=CPU)

    async def drive():
        daemon.submit(allocd.Admit("a", 4))
        daemon.submit(allocd.Admit("b", 3))
        await daemon.step_period()               # fresh
        daemon.solver_timeout_s = 0.02
        daemon._solver_delay_s = 0.4
        stale = await daemon.step_period()       # deadline miss
        daemon.solver_timeout_s = None
        daemon._solver_delay_s = 0.0
        fresh = await daemon.step_period()       # the pending solve commits
        await daemon.close()
        return stale, fresh

    stale, fresh = asyncio.run(drive())
    assert stale.stale and not fresh.stale
    assert daemon.plane.metrics["stale_decisions"] == 1
    assert [d.stale for d in daemon.served] == [False, True, False]
    assert not any(d.stale for d in daemon.plane.decisions)
    np.testing.assert_allclose(stale.b.sum(),
                               daemon.plane.net.total_bandwidth_mhz,
                               rtol=1e-5)


def test_solver_error_propagates_instead_of_serving_stale():
    daemon = allocd.AllocDaemon(ControlPlaneConfig(**PERSIST), device=CPU,
                                solver_timeout_s=5.0)

    def broken():
        raise RuntimeError("kernel launch failed")

    async def drive():
        daemon.submit(allocd.Admit("a", 4))
        await daemon.step_period()
        daemon.plane.tick = broken
        await daemon.step_period()

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        asyncio.run(drive())
    assert daemon.plane.metrics["stale_decisions"] == 0
    assert len(daemon.served) == 1


def test_stale_streak_degrades_to_equal_share():
    cfg = ControlPlaneConfig(capacity=4, k_max=4, rounds_required=5000)

    async def drive():
        daemon = allocd.AllocDaemon(cfg, max_stale_streak=2, device=CPU)
        daemon.submit(allocd.Admit("a", 3))
        daemon.submit(allocd.Admit("b", 2))
        await daemon.step_period()
        flags = []
        for _ in range(4):
            daemon._force_stale_next = True
            d = await daemon.step_period()
            flags.append((d.stale, d.degraded))
        await daemon.close()
        return flags, daemon

    flags, daemon = asyncio.run(drive())
    assert flags == [(True, False), (True, True), (True, True), (True, True)]
    assert daemon.plane.metrics["degraded_decisions"] == 3
    d = daemon.served[-1]
    np.testing.assert_allclose(float(np.sum(d.b)),
                               daemon.plane.net.total_bandwidth_mhz,
                               rtol=1e-5)
    assert np.all(d.f == 0.0)


@pytest.mark.parametrize("frees", [True, False])
def test_bounded_admit_retry(frees):
    """A capacity rejection retries with period backoff: it lands once a
    slot frees, and otherwise gives up after ``admit_max_retries``."""
    cfg = ControlPlaneConfig(capacity=1, k_max=4, rounds_required=5000)

    async def drive():
        daemon = allocd.AllocDaemon(cfg, admit_max_retries=2, device=CPU)
        daemon.submit(allocd.Admit("a", 2))
        await daemon.step_period()
        daemon.submit(allocd.Admit("b", 2))      # capacity full -> retry
        await daemon.step_period()
        assert daemon.rejections == []
        if frees:
            daemon.plane.retire("a")
        for _ in range(6):
            await daemon.step_period()
        await daemon.close()
        return daemon

    daemon = asyncio.run(drive())
    assert daemon._retry_queue == []
    assert daemon.plane.metrics["admit_retries"] >= 1
    if frees:
        assert "b" in daemon.plane.services and daemon.rejections == []
    else:
        assert len(daemon.rejections) == 1
        sid, reason = daemon.rejections[0]
        assert sid == "b" and "gave up after 2 retries" in reason


def test_checkpoint_restart_resumes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "cp"))
    cfg = ControlPlaneConfig(**PERSIST)
    d1 = allocd.AllocDaemon(cfg, manager=mgr, save_every=2, device=CPU)
    assert not d1.resumed

    async def drive(daemon, n):
        daemon.submit(allocd.Admit("a", 4))
        for _ in range(n):
            await daemon.step_period()
        await daemon.close()

    asyncio.run(drive(d1, 5))
    d2 = allocd.AllocDaemon(cfg, manager=mgr, save_every=2, device=CPU)
    assert d2.resumed and d2.plane.period == 5
    assert "a" in d2.plane.services and d2.plane.replayable
    tail = asyncio.run(d2.serve(2))
    assert [d.period for d in tail] == [5, 6]


def test_cli_check_is_bitwise(capsys):
    summary = allocd.main(["--device", "cpu", "--check", "--periods", "16"])
    out = capsys.readouterr().out
    assert "bitwise equal" in out and "on cpu" in out
    assert summary["replay"] == {"periods": 16, "bitwise": True}
    assert summary["metrics"]["admitted"] > 0
    assert summary["metrics"]["retired"] > 0


def test_poisson_admissions_match_reference():
    got = allocd.poisson_admissions(np.random.default_rng(3), 0.7, 30, 12)
    want = j_allocd.poisson_admissions(np.random.default_rng(3), 0.7, 30, 12)
    assert {p: [(r.service_id, r.n_clients) for r in reqs]
            for p, reqs in got.items()} == {
        p: [(r.service_id, r.n_clients) for r in reqs]
        for p, reqs in want.items()}


def test_mailbox_tags_are_disjoint_across_threads():
    """B3's host-side tag counter, taken by 8 threads at once (the daemon's
    executor threads may launch), hands out disjoint tag ranges."""
    boxes = market_clear._Mailboxes()
    cpu = torch.device("cpu")
    ranges, lock = [], threading.Lock()
    start = threading.Barrier(8)

    def worker(folds):
        start.wait()
        for _ in range(200):
            _, _, have, tag = boxes.take(cpu, 64, folds)
            with lock:
                ranges.append((tag, tag + folds))

    threads = [threading.Thread(target=worker, args=(1 + i % 3,))
               for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    ranges.sort()
    assert len(ranges) == 1600
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    assert boxes.next_tag[None] == ranges[-1][1]
