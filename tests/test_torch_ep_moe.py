"""The port's expert-parallel MoE, ``reshard`` and ``constrain`` over ranks
against the JAX package's.

Eight gloo ranks (``torch_ranks.py``'s ``ep_moe`` job, one launch for the
file) on a (data 2, model 4) mesh, and on a (pod 2, data 2, model 2) one,
run ``moe.apply_moe``, which dispatches to ``_apply_moe_ep``, on the JAX
package's parameters and inputs: the whole values on every rank, then
``elastic.reshard``'s DTensors (FSDP off and on) with x split over the
data axes.  The JAX side runs in a subprocess with eight host devices, as
``tests/test_distributed.py``'s EP test does, on the same meshes:
its EP output and aux, its dense oracle, ``jax.grad`` of sum(out ** 2) +
AUX_WEIGHT aux with the parameters placed by its own rules, and each
parameter's ``NamedSharding(...).devices_indices_map`` slices, matched to
the ranks by mesh coordinate.  Output, aux and gradients within rtol 2e-4
/ atol 2e-5 (the JAX EP test's), gradients' atol scaled by the largest
|grad| of the leaf; ``reshard``'s local blocks bitwise.  The settings: the
JAX test's (capacity 8.0, nothing dropped: the dense oracle holds), and
capacity 1.0 with a shared expert (slots dropped per data shard) on both
meshes.
Without ranks: the dispatch condition, and a mesh without ranks refused.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import api
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves_with_names
from torch_ranks import launch

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
MESH = ((2, 4), ("data", "model"))
PODS = ((2, 2, 2), ("pod", "data", "model"))
AUX_WEIGHT = 3.0
RTOL, ATOL = 2e-4, 2e-5
BASE = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, head_dim=16, d_ff=0, vocab_size=64, n_experts=8,
            n_experts_per_token=2, d_ff_expert=48, dtype="float32")
DROPPING = dict(BASE, capacity_factor=1.0, n_shared_experts=1)
CASES = {   # name -> (ModelConfig fields, mesh)
    # tests/test_distributed.py's EP setting: nothing dropped
    "jax_test": (dict(BASE, capacity_factor=8.0), MESH),
    # capacity 1.0: each data shard drops slots; one shared expert
    "dropping_shared": (DROPPING, MESH),
    # the tokens split over (pod, data), pod-major
    "pods": (DROPPING, PODS),
}
CONSTRAIN = np.arange(8 * 6 * 12, dtype=np.float32).reshape(8, 6, 12)

JAX_SIDE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import AxisType, make_mesh
    from repro.distributed import api as dist_api, sharding
    from repro.models import moe
    from repro.models.config import ModelConfig

    cases, aux_weight, out_path = pickle.load(open(sys.argv[1], "rb"))
    keystr = jax.tree_util.keystr
    result = {}
    for name, (fields, (sizes, names)) in cases.items():
        mesh = make_mesh(sizes, names,
                         axis_types=(AxisType.Auto,) * len(sizes))
        where = {mesh.devices[c]: c for c in np.ndindex(*mesh.devices.shape)}
        cfg = ModelConfig(**fields)
        p = moe.init_moe(jax.random.key(0), cfg)
        x = jax.random.normal(jax.random.key(1), (8, 16, cfg.d_model))

        def loss(p_, x_):
            o, a = moe.apply_moe(p_, x_, cfg)
            return jnp.sum(o ** 2) + aux_weight * a

        res = {"p": jax.tree.map(np.asarray, p), "x": np.asarray(x),
               "dense": np.asarray(moe.apply_moe_dense_ref(p, x, cfg))}
        dist_api.set_mesh(mesh)
        out, aux = jax.jit(lambda p_, x_: moe.apply_moe(p_, x_, cfg))(p, x)
        res["out"], res["aux"] = np.asarray(out), float(aux)
        for fsdp in (False, True):
            sh = sharding.param_shardings(cfg, p, mesh, fsdp=fsdp)
            placed = jax.device_put(p, sh)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(placed, x)
            slices = {}
            for (path, leaf), s in zip(
                    jax.tree_util.tree_leaves_with_path(p),
                    jax.tree.leaves(sh, is_leaf=lambda v: hasattr(v, "spec"))):
                slices[keystr(path)] = {
                    where[dev]: tuple((ix.start or 0, ix.stop or n)
                                      for ix, n in zip(idx, leaf.shape))
                    for dev, idx in s.devices_indices_map(leaf.shape).items()}
            res[f"fsdp={fsdp}"] = {
                "grads": {keystr(k): np.asarray(v) for k, v in
                          jax.tree_util.tree_leaves_with_path(gp)},
                "x_grad": np.asarray(gx), "slices": slices}
        dist_api.set_mesh(None)
        result[name] = res
    pickle.dump(result, open(out_path, "wb"))
    """)


@pytest.fixture(scope="module")
def jax_side():
    with tempfile.TemporaryDirectory() as tmp:
        args, out = Path(tmp) / "args.pkl", Path(tmp) / "out.pkl"
        with open(args, "wb") as fh:
            pickle.dump((CASES, AUX_WEIGHT, str(out)), fh)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(args)],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out, "rb") as fh:
            return pickle.load(fh)


@pytest.fixture(scope="module")
def ranks(jax_side):
    cases = {name: {"cfg": CASES[name][0], "mesh": CASES[name][1],
                    "p": res["p"], "x": res["x"]}
             for name, res in jax_side.items()}
    return launch("ep_moe", RANKS, {"cases": cases, "aux_weight": AUX_WEIGHT,
                                    "constrain": CONSTRAIN})


RUNS = ("plain", "fsdp=False", "fsdp=True")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("run", RUNS)
def test_ep_output_and_aux_match_jax(ranks, jax_side, case, run):
    """Every rank's whole output and aux equal JAX's EP; a DTensor input
    gives a DTensor back, a plain one a plain tensor."""
    want = jax_side[case]
    for rank in ranks:
        got = rank[case][run]
        assert got["type"] == ("Tensor" if run == "plain" else "DTensor")
        np.testing.assert_allclose(got["out"], want["out"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL,
                                   atol=ATOL)


def test_ep_matches_dense_oracle(ranks, jax_side):
    """At the JAX test's capacity nothing is dropped: the EP output is the
    dense oracle's (``tests/test_distributed.py``'s check)."""
    for rank in ranks:
        for run in RUNS:
            np.testing.assert_allclose(rank["jax_test"][run]["out"],
                                       jax_side["jax_test"]["dense"],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["dropping_shared", "pods"])
def test_ep_drops_slots_per_data_shard(jax_side, case):
    """The capacity-1.0 cases really drop: their EP output leaves the
    dense oracle (so they check the per-shard capacity, not luck)."""
    want = jax_side[case]
    assert np.abs(want["out"] - want["dense"]).max() > 1e-2


def _grad_close(got, want, label):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=label)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_ep_gradients_match_jax_grad(ranks, jax_side, case, fsdp):
    """Gradients of sum(out ** 2) + AUX_WEIGHT aux with respect to every
    parameter and x, on every rank and in every run (plain, and reshard's
    DTensors at this FSDP setting), against ``jax.grad`` of the same loss
    with the parameters placed by the JAX rules at that setting."""
    want = jax_side[case][f"fsdp={fsdp}"]
    for rank in ranks:
        for run in ("plain", f"fsdp={fsdp}"):
            got = rank[case][run]
            assert set(got["grads"]) == set(want["grads"])
            for path, g in got["grads"].items():
                _grad_close(g, want["grads"][path], f"{case} {run} {path}")
            _grad_close(got["x_grad"], want["x_grad"], f"{case} {run} x")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_reshard_blocks_bitwise_jax_slices(ranks, jax_side, case, fsdp):
    """Each rank's local block of every resharded leaf is bitwise the
    slice JAX's ``NamedSharding`` gives the device at the same mesh
    coordinate; some leaf is split (FSDP splits more)."""
    want = jax_side[case]
    slices = want[f"fsdp={fsdp}"]["slices"]
    full = dict(leaves_with_names(want["p"]))
    split = 0
    for rank in ranks:
        local = rank[case][f"fsdp={fsdp}"]["local"]
        assert set(local) == set(slices)
        for path, block in local.items():
            idx = tuple(slice(a, b)
                        for a, b in slices[path][rank[case]["coords"]])
            np.testing.assert_array_equal(block, full[path][idx],
                                          err_msg=path)
            split += block.size < full[path].size
    assert split > 0


def test_constrain_redistributes_a_dtensor(ranks):
    """``constrain`` takes a replicated DTensor to (batch over data, vocab
    over model); a dim the model axis does not divide (6 over 4) stays
    whole; a plain tensor comes back as it is."""
    coords = sorted(rank["constrain"]["coords"] for rank in ranks)
    assert coords == [(d, m) for d in range(2) for m in range(4)]
    for rank in ranks:
        got = rank["constrain"]
        d, m = got["coords"]
        np.testing.assert_array_equal(
            got["vocab_last"], CONSTRAIN[4 * d:4 * d + 4, :, 3 * m:3 * m + 3])
        np.testing.assert_array_equal(got["vocab_middle"],
                                      CONSTRAIN[4 * d:4 * d + 4])
        assert got["plain_unchanged"]


# ---------------------------------------------------------------------------
# Without ranks.
# ---------------------------------------------------------------------------

def _layer(cfg):
    return moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.parametrize("tokens,expect_ep", [
    ((8, 16), True),     # T = 128 >= 8 E, divides data 2
    ((1, 63), False),    # T < 8 E: decode-sized, the generic path
    ((9, 15), False),    # T = 135 does not divide data 2
])
def test_dispatch_condition(tokens, expect_ep):
    """With a mesh registered, ``apply_moe`` takes the EP path exactly
    under the JAX package's condition; here the mesh has no ranks, so the
    EP path refuses and the generic one runs as without a mesh."""
    cfg = ModelConfig(**CASES["jax_test"][0])
    p = _layer(cfg)
    x = torch.randn(*tokens, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want = moe.apply_moe(p, x, cfg)
    api.set_mesh(mesh_lib.Mesh(*reversed(MESH)))
    try:
        if expect_ep:
            with pytest.raises(ValueError, match="has no ranks"):
                moe.apply_moe(p, x, cfg)
        else:
            got = moe.apply_moe(p, x, cfg)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    finally:
        api.set_mesh(None)


def test_ep_on_a_one_rank_world_is_the_generic_layer():
    """A one-rank mesh without a process group: the EP path runs every
    expert on the one rank, with no collective -- the generic layer's
    output and aux exactly (the same products in the same order)."""
    cfg = ModelConfig(**DROPPING)
    p = _layer(cfg)
    x = torch.randn(8, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want = moe.apply_moe(p, x, cfg)
    api.set_mesh(mesh_lib.make_mesh((1, 1), ("data", "model")))
    try:
        got = moe.apply_moe(p, x, cfg)
    finally:
        api.set_mesh(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_set_mesh_is_per_thread():
    """The registered mesh is the registering thread's."""
    import threading

    seen = []
    api.set_mesh(mesh_lib.Mesh(("data", "model"), (2, 4)))
    try:
        thread = threading.Thread(target=lambda: seen.append(api.get_mesh()))
        thread.start()
        thread.join(10)
        assert not thread.is_alive() and seen == [None]
        assert api.get_mesh().shape == {"data": 2, "model": 4}
    finally:
        api.set_mesh(None)
