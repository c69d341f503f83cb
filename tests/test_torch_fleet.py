"""The port's fleet engine (``run_fleet``), legacy checkpointable engine
(``run``) and ``network.table1_service_set``.

``fleet_geometry`` keeps the reference's chunk arithmetic for one rank
(several ranks: ``test_torch_distributed.py``);
``run_fleet`` is bitwise ``run_batch`` per seed at every chunk size and
remainder (the cases of ``tests/test_fleet.py`` without a mesh), and
without ``collect_history`` returns no (S, T) array.  The legacy ``run``
reproduces ``run_scan``'s durations, resumes from its own JSON snapshot to
the uninterrupted result, and refuses a snapshot of another draw stream.
The table-1 period is the reference's on injected draws (rtol 1e-5, the
bound of ``services_from_draws``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as j_network
from repro.fl import simulator as j_sim
from repro_torch import scenarios
from repro_torch.core import network
from repro_torch.fl import simulator
from repro_torch.launch import mesh as mesh_lib
from test_torch_scenarios import _raw_fn, _t

CPU = torch.device("cpu")
BASE = dict(policy="es", n_services_total=3, rounds_required=100,
            p_arrive=2.0, max_periods=60, k_max=16)


def _cfg(**kw) -> simulator.SimConfig:
    return simulator.SimConfig(**{**BASE, **kw})


@pytest.mark.parametrize("n_seeds", [1, 2, 5, 7, 64, 65, 130])
@pytest.mark.parametrize("chunk_size", [None, 1, 2, 3, 64, 100])
def test_fleet_geometry_matches_reference_one_device(n_seeds, chunk_size):
    seeds = list(range(10, 10 + n_seeds))
    mesh, axis, n_dev, chunk, n_chunks, padded = simulator.fleet_geometry(
        seeds, None, chunk_size)
    assert (chunk, n_chunks, len(padded)) == j_sim._fleet_shape(
        n_seeds, 1, chunk_size)
    assert mesh.axis_names == ("seeds",) and mesh.device_mesh is None
    assert axis == "seeds" and n_dev == 1
    assert padded[:n_seeds] == seeds
    assert set(padded[n_seeds:]) <= {seeds[-1]}
    assert simulator.FLEET_CHUNK == j_sim.FLEET_CHUNK


def test_fleet_rejects_empty_and_meshes():
    """As the reference: no seeds, or a mesh of more than one axis, raise
    ``ValueError``."""
    with pytest.raises(ValueError, match="at least one seed"):
        simulator.run_fleet(_cfg(), [], device=CPU)
    mesh2d = mesh_lib.make_mesh((1, 1), ("a", "b"))
    with pytest.raises(ValueError, match="one-axis mesh"):
        simulator.run_fleet(_cfg(), [0], mesh=mesh2d, device=CPU)


def test_fleet_bitwise_equals_batch_and_scan_uneven_chunked():
    cfg = _cfg()
    seeds = [0, 1, 2, 3, 4]
    fleet = simulator.run_fleet(cfg, seeds, chunk_size=2, device=CPU)
    assert fleet["fleet"] == {"n_devices": 1, "mesh_axis": "seeds",
                              "chunk": 2, "n_chunks": 3, "padded_to": 6}
    batch = simulator.run_batch(cfg, seeds, device=CPU)
    assert fleet["seeds"] == seeds
    for key in ("durations", "finished", "avg_duration", "std_duration",
                "fallbacks"):
        np.testing.assert_array_equal(fleet[key], batch[key])
    for key in batch["history"]:
        np.testing.assert_array_equal(fleet["history"][key],
                                      batch["history"][key])
    single = simulator.run_scan(dataclasses.replace(cfg, seed=3), device=CPU)
    assert list(fleet["durations"][3]) == single["durations"]
    p = single["periods"]
    np.testing.assert_array_equal(fleet["history"]["freq_sum"][3][:p],
                                  single["history"]["freq_sum"])


@pytest.mark.parametrize("chunk_size", [1, 3, None])
def test_fleet_invariant_to_chunk_size_without_history(chunk_size):
    cfg = _cfg(collect_history=False)
    seeds = [0, 1, 2, 3]
    fleet = simulator.run_fleet(cfg, seeds, chunk_size=chunk_size,
                                device=CPU)
    batch = simulator.run_batch(cfg, seeds, device=CPU)
    np.testing.assert_array_equal(fleet["durations"], batch["durations"])
    np.testing.assert_array_equal(fleet["periods"], batch["periods"])
    for key in simulator._AGG_KEYS:
        np.testing.assert_array_equal(fleet["totals"][key],
                                      batch["totals"][key])
    # per-seed scalars only: no (S, T) array anywhere in the result
    assert fleet["history"] is None

    def arrays(x):
        if isinstance(x, dict):
            return [a for v in x.values() for a in arrays(v)]
        return [x] if isinstance(x, np.ndarray) else []

    assert all(a.ndim <= 1 or a.shape == (4, cfg.n_services_total)
               for a in arrays(fleet))


def test_fleet_warm_start_carry_across_chunks():
    cfg = _cfg(policy="coop", rounds_required=80, max_periods=40,
               warm_start=True)
    seeds = [0, 1, 2]
    fleet = simulator.run_fleet(cfg, seeds, chunk_size=1, device=CPU)
    batch = simulator.run_batch(cfg, seeds, device=CPU)
    np.testing.assert_array_equal(fleet["durations"], batch["durations"])
    for key in ("freq_sum", "objective"):
        np.testing.assert_array_equal(fleet["history"][key],
                                      batch["history"][key])


def test_table1_service_set_matches_reference_on_injected_draws():
    j_net, net = j_network.NetworkConfig(), network.NetworkConfig()
    key = jax.random.key(5)
    j_svc, j_meta = j_network.table1_service_set(key, j_net)
    counts = jnp.asarray(network.TABLE1_COUNTS, jnp.int32)
    raw = [_t(x) for x in _raw_fn(5, 18, j_net)(key, counts)]
    draws = network.ServiceDraws(_t(network.TABLE1_COUNTS, np.int32), 18,
                                 *raw)
    svc, meta = network.table1_service_set(cfg=net, draws=draws)
    for field in ("alpha", "t_comp", "alpha_ul"):
        np.testing.assert_allclose(getattr(svc, field).numpy(),
                                   np.asarray(getattr(j_svc, field)),
                                   rtol=1e-5)
    assert np.array_equal(svc.mask.numpy(), np.asarray(j_svc.mask))
    assert svc.client_counts().tolist() == [10, 12, 14, 16, 18]
    # its own draws: seeded, the same shape and counts
    own, _ = network.table1_service_set(3)
    again, _ = network.table1_service_set(torch.Generator().manual_seed(3))
    assert torch.equal(own.alpha, again.alpha)
    assert own.alpha.shape == (5, 18)
    with pytest.raises(ValueError, match="table1"):
        network.table1_service_set(draws=draws._replace(k_max=17))


LEGACY_CASES = {
    "es_iid": dict(policy="es", rounds_required=60, max_periods=40),
    "coop_warm_gauss_markov": dict(
        policy="coop", warm_start=True, rounds_required=60, max_periods=40,
        channel_process=scenarios.spec("gauss_markov", rho=0.9)),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_run_matches_run_scan_and_resumes(case, tmp_path):
    cfg = _cfg(**LEGACY_CASES[case])
    scan = simulator.run_scan(cfg, device=CPU)
    full = simulator.run(cfg, device=CPU)
    assert full["durations"] == scan["durations"]
    assert full["periods"] == scan["periods"]
    assert full["finished"] == scan["finished"]
    assert full["state"]["draw_stream"] == simulator.DRAW_STREAM
    # the history holds the periods with an active service
    active = [p for p in range(scan["periods"])
              if scan["history"]["n_active"][p] > 0]
    assert [h["period"] for h in full["history"]] == active
    np.testing.assert_allclose([h["freq_sum"] for h in full["history"]],
                               scan["history"]["freq_sum"][active],
                               rtol=0, atol=0)
    # interrupted after period 2, resumed from the snapshot on disk
    path = str(tmp_path / "episode.json")
    part = simulator.run(dataclasses.replace(cfg, max_periods=2),
                         checkpoint_path=path, device=CPU)
    assert part["periods"] == 2 and not (tmp_path / "episode.json.tmp").exists()
    with open(path) as fp:
        snap = json.load(fp)
    assert snap["period"] == 2
    resumed = simulator.run(cfg, state=snap, device=CPU)
    assert resumed["durations"] == full["durations"]
    assert resumed["history"] == full["history"]
    assert resumed["state"] == full["state"]
    if cfg.warm_start:
        assert len(snap["pol_state"]) == 2 and len(snap["chan_state"]) == 2


def test_legacy_run_refuses_foreign_draw_streams():
    cfg = _cfg(max_periods=12)
    part = simulator.run(dataclasses.replace(cfg, max_periods=4), device=CPU)
    state = dict(part["state"])
    assert simulator.DRAW_STREAM != j_sim.DRAW_STREAM
    resumed = simulator.run(cfg, state=dict(state), device=CPU)
    assert resumed["durations"] == simulator.run(cfg, device=CPU)["durations"]
    state["draw_stream"] = j_sim.DRAW_STREAM          # "device/v1"
    with pytest.raises(ValueError, match="draw stream"):
        simulator.run(cfg, state=state, device=CPU)
    state.pop("draw_stream")
    with pytest.raises(ValueError, match="draw stream"):
        simulator.run(cfg, state=state, device=CPU)


def test_legacy_run_aggregate_mode_and_stateful_guard():
    cfg = _cfg(rounds_required=40, max_periods=30, collect_history=False)
    out = simulator.run(cfg, device=CPU)
    scan = simulator.run_scan(cfg, device=CPU)
    assert out["history"] is None and out["durations"] == scan["durations"]
    np.testing.assert_allclose(out["totals"]["freq_sum"],
                               scan["totals"]["freq_sum"], rtol=1e-5)
    assert out["totals"]["n_active"] == scan["totals"]["n_active"]
    # a stateless snapshot resumed under a stateful configuration
    snap = simulator.run(dataclasses.replace(cfg, max_periods=3),
                         device=CPU)["state"]
    snap["chan_state"] = snap["churn_state"] = snap["pol_state"] = []
    with pytest.raises(ValueError, match="leaves"):
        simulator.run(_cfg(policy="coop", warm_start=True), state=snap,
                      device=CPU)
