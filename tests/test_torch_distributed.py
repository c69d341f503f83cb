"""The port's distribution layer for allocation against the JAX package's.

``launch/mesh.py`` (meshes over the ranks of a world; a mesh must take the
whole world), ``distributed/collectives.py``, ``distributed/elastic.py``
and the fleets over ranks (``run_fleet`` / ``run_cotrain_fleet`` with a
mesh).  Eight gloo ranks (``torch_ranks.py``, one launch for the file)
run the mirrors of ``tests/test_distributed.py``'s collectives on a
(pod 2, data 4) mesh -- the hierarchical psum exact (rtol 1e-6), the
int8-compressed one within its bound and equal to the sum of the JAX
package's ``_quantize_int8`` blocks -- and of ``tests/test_fleet.py``'s
and ``tests/test_cotrain.py``'s fleets: bitwise per seed against the
port's ``run_batch`` / ``run_cotrain_batch``, with the ``"fleet"`` record
of the reference's ``_fleet_shape`` for eight devices.  The elastic plan
is pure arithmetic and equals the JAX function's output.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as j_collectives
from repro.distributed import elastic as j_elastic
from repro.fl import simulator as j_sim
from repro_torch import scenarios
from repro_torch.core import network
from repro_torch.distributed import collectives, elastic
from repro_torch.fl import cotrain, simulator
from repro_torch.launch import mesh as mesh_lib
from torch_ranks import launch

CPU = torch.device("cpu")
RANKS = 8
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")
X = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
FLEET = simulator.SimConfig(
    policy="coop", n_services_total=3, rounds_required=80, p_arrive=2.0,
    max_periods=80, k_max=24, warm_start=True,
    channel_process=scenarios.spec("gauss_markov", rho=0.9),
    churn_process=scenarios.spec("bernoulli", p_drop=0.1))
COTRAIN = simulator.SimConfig(
    policy="coop", warm_start=True, n_services_total=3, rounds_required=30,
    p_arrive=2.0, max_periods=24, k_max=12, mean_clients=5.0,
    var_clients=2.0)
NET = network.NetworkConfig(period_s=1.0, mean_clients=5.0, var_clients=2.0)
TRAIN = cotrain.TrainSpec(vocab=16, seq_len=6, batch_size=2, eval_batch=8,
                          rounds_cap=2)
FLEETS = {
    # name -> (engine, args, kwargs, seeds)
    "eleven": ("run_fleet", (FLEET, list(range(11))), {"chunk_size": 2}),
    "three": ("run_fleet", (FLEET, [0, 1, 2]), {"chunk_size": 2}),
    "explicit_mesh": ("run_fleet", (FLEET, [3, 4, 5, 6, 7]),
                      {"explicit_mesh": True}),
    "cotrain": ("run_cotrain_fleet", (COTRAIN, TRAIN, [0, 1, 2, 3, 4], NET),
                {"chunk_size": 2}),
}


@pytest.fixture(scope="module")
def ranks():
    return launch("distributed", RANKS, {"x": X, "fleets": FLEETS})


def _blocks():
    """The (pod, data) ranks' blocks of X: (2, 4, 4, 16)."""
    return X.reshape(2, 4, 4, 16)


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

def test_hierarchical_psum_eight_ranks(ranks):
    """Every rank gets the plain sum of the eight (4, 16) blocks, as the
    reference's out_specs tile it; ``make_hierarchical_allreduce`` too."""
    expect = X.reshape(8, 4, 16).sum(0)
    assert sorted(r["block"] for r in ranks) == list(range(RANKS))
    for rank in ranks:
        assert rank["world"] == RANKS
        np.testing.assert_allclose(rank["hierarchical"], expect, rtol=1e-6)
        np.testing.assert_array_equal(rank["made"], rank["hierarchical"])


def _scattered():
    """Each (pod, data) rank's reduce-scattered block: row ``data`` of
    the sum of its pod's four blocks."""
    pods = _blocks().sum(1)                  # (pod, 4 rows, 16)
    return [[pods[p, d:d + 1] for d in range(4)] for p in range(2)]


def test_compressed_psum_int8_eight_ranks(ranks):
    """Within the reference test's bound of the plain sum, residual
    bounded, and equal to the sum over pods of the JAX package's
    quantized blocks (residual: the pod's own rounding error)."""
    expect = X.reshape(8, 4, 16).sum(0)
    scale = np.abs(expect).max()
    deq, err = [], []
    for pod in _scattered():
        row_deq, row_err = [], []
        for s in pod:
            q, sc = j_collectives._quantize_int8(jnp.asarray(s))
            d = np.asarray(q, np.float32) * np.float32(sc)
            row_deq.append(d)
            row_err.append(s - d)
        deq.append(np.concatenate(row_deq))
        err.append(np.concatenate(row_err))
    for rank in ranks:
        full, resid = rank["compressed"]
        assert np.abs(full - expect).max() < 0.02 * scale + 1e-3
        assert np.abs(resid).max() < scale
        np.testing.assert_allclose(full, deq[0] + deq[1], rtol=1e-6)
        np.testing.assert_allclose(resid, err[rank["block"] // 4], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("which", ["scattered", "random"])
def test_quantize_int8_matches_reference(which):
    rng = np.random.default_rng(0)
    blocks = ([s for pod in _scattered() for s in pod] if which == "scattered"
              else [rng.normal(size=(4, 16)).astype(np.float32) * 10 ** e
                    for e in (-3, 0, 4)] + [np.zeros((2, 3), np.float32)])
    for block in blocks:
        q, scale = collectives._quantize_int8(torch.as_tensor(block))
        jq, jscale = j_collectives._quantize_int8(jnp.asarray(block))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)


def test_collectives_on_one_rank_are_the_identity():
    """Without a process group every axis has size 1: the hierarchical
    psum returns its input, the compressed one its quantized input and
    the rounding error."""
    mesh = mesh_lib.make_mesh((1, 1), ("pod", "data"))
    x = torch.as_tensor(X[:4])
    assert torch.equal(collectives.hierarchical_psum(x, "data", "pod",
                                                     mesh=mesh), x)
    full, resid = collectives.compressed_psum_int8(x, "data", "pod",
                                                   mesh=mesh)
    q, scale = collectives._quantize_int8(x)
    assert torch.equal(full, q.float() * scale)
    assert torch.equal(resid, x - full)
    assert torch.equal(collectives.all_reduce(x, mesh, ("pod", "data"),
                                              "max"), x)


# ---------------------------------------------------------------------------
# Meshes and the elastic plan.
# ---------------------------------------------------------------------------

def test_meshes_take_the_whole_world(ranks):
    """A mesh's sizes must multiply to the world size: other counts raise
    naming the world and the ranks to launch, at 8 ranks and at 1."""
    for rank in ranks:
        refused = rank["refusals"]
        assert "the world has 8" in refused["fleet_4"]
        assert "launch 4 ranks" in refused["fleet_4"]
        assert "needs 256 ranks" in refused["production"]
        assert "needs 16 ranks" in refused["elastic_16"]
        assert rank["elastic"] == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="the world has 1"):
        mesh_lib.make_fleet_mesh(2)
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)
    assert mesh_lib.make_fleet_mesh().shape == {"seeds": 1}
    assert mesh_lib.make_fleet_mesh(1).axis_names == ("seeds",)
    assert elastic.remesh(1).shape == {"data": 1, "model": 1}


def test_elastic_remesh_factorizations():
    plan = elastic.plan_service_remesh(256, 240, model_parallel=16)
    assert plan["before"] == {"data": 16, "model": 16}
    assert plan["after"] == {"data": 15, "model": 16}
    assert not plan["model_parallel_changed"]
    plan2 = elastic.plan_service_remesh(256, 252, model_parallel=16)
    assert plan2["after"]["model"] == 4
    assert plan2["model_parallel_changed"]


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 8, 16, 32])
def test_elastic_plan_matches_reference(model_parallel):
    for before in (1, 8, 64, 240, 256, 512):
        for after in (1, 3, 7, 12, 96, 250, 252, 256, 510):
            assert elastic.plan_service_remesh(
                before, after, model_parallel) == j_elastic.plan_service_remesh(
                before, after, model_parallel)


# ---------------------------------------------------------------------------
# Fleets over ranks.
# ---------------------------------------------------------------------------

def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _assert_same(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}/{i}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("n_seeds", [1, 3, 7, 11, 64, 130])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("chunk_size", [None, 1, 2, 64])
def test_fleet_shape_matches_reference(n_seeds, n_dev, chunk_size):
    assert simulator._fleet_shape(n_seeds, n_dev, chunk_size) == \
        j_sim._fleet_shape(n_seeds, n_dev, chunk_size)


@pytest.mark.parametrize("name", ["eleven", "three", "explicit_mesh"])
def test_fleet_eight_ranks_bitwise_per_seed(ranks, name):
    """Every rank returns the whole summary, per seed bitwise the port's
    ``run_batch`` (warm ``coop``, gauss_markov, bernoulli churn); 3 seeds
    leave five ranks with only pad seeds; the ``"fleet"`` record is the
    reference's geometry for eight devices."""
    _, (cfg, seeds), kwargs = FLEETS[name]
    batch = simulator.run_batch(cfg, seeds, device=CPU)
    chunk, n_chunks, padded_to = j_sim._fleet_shape(
        len(seeds), RANKS, kwargs.get("chunk_size"))
    for rank in ranks:
        fleet = dict(rank["fleets"][name])
        assert fleet.pop("fleet") == {
            "n_devices": RANKS, "mesh_axis": "seeds", "chunk": chunk,
            "n_chunks": n_chunks, "padded_to": padded_to}
        _assert_same(fleet, batch)


def test_cotrain_fleet_eight_ranks_bitwise_per_seed(ranks):
    """``run_cotrain_fleet`` over eight ranks, five seeds at chunk 2: per
    seed bitwise the port's ``run_cotrain_batch``."""
    _, (cfg, train, seeds, net), kwargs = FLEETS["cotrain"]
    batch = cotrain.run_cotrain_batch(cfg, train, seeds, net, device=CPU)
    chunk, n_chunks, padded_to = j_sim._fleet_shape(len(seeds), RANKS, 2)
    for rank in ranks:
        fleet = dict(rank["fleets"]["cotrain"])
        assert fleet.pop("fleet")["padded_to"] == padded_to == 8
        _assert_same(fleet, batch)


def test_cotrain_fleet_rejects_multiaxis():
    with pytest.raises(ValueError, match="one-axis mesh"):
        cotrain.run_cotrain_fleet(COTRAIN, TRAIN, [0], NET,
                                  mesh=mesh_lib.make_mesh((1, 1), ("a", "b")),
                                  device=CPU)


@needs_cuda
@pytest.mark.parametrize("backend", ["pallas", "megakernel"])
def test_fleet_on_the_card_bitwise_per_seed(backend):
    """On the card (one rank, the kernel backends): ``run_fleet`` per seed
    bitwise ``run_batch``."""
    cfg = dataclasses.replace(FLEET, intra_backend=backend)
    seeds = [0, 1, 2]
    fleet = simulator.run_fleet(cfg, seeds, chunk_size=2, device="cuda")
    assert fleet.pop("fleet")["n_devices"] == 1
    _assert_same(fleet, simulator.run_batch(cfg, seeds, device="cuda"))
