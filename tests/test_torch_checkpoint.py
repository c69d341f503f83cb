"""The port's ``CheckpointManager``: the reference's layout on disk
(``step_<N>/meta.json``, ``shard_<i>.npz``, ``COMMIT`` last, sha256 per
shard) and its recovery rules, and checkpoints that cross between the two
packages bitwise (trees of plain dicts of arrays; the leaf names are the
reference's key paths)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.policy import WarmDualState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 3), generator=g),
                       "b": torch.randn((3,), generator=g)},
            "layers": [torch.arange(5, dtype=torch.int32),
                       (torch.ones(2, dtype=torch.bool),
                        torch.randn((2, 2), generator=g).to(torch.bfloat16))],
            "state": WarmDualState(lam=torch.tensor(0.25),
                                   fallbacks=torch.tensor(3, dtype=torch.int32)),
            "empty": None}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_save_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = _tree()
    path = mgr.save(7, tree, extra={"period": 7})
    assert sorted(os.listdir(path)) == ["COMMIT", "meta.json",
                                        "shard_0000.npz"]
    with open(os.path.join(path, "meta.json")) as fp:
        meta = json.load(fp)
    assert meta["leaf_names"][:3] == ["['layers'][0]", "['layers'][1][0]",
                                      "['layers'][1][1]"]
    assert "['state'].lam" in meta["leaf_names"]
    assert set(meta["shard_checksums"]) == {"shard_0000.npz"}
    like = _tree(seed=1)
    restored, extra = mgr.restore(7, like)
    _assert_tree_equal(restored, tree)
    assert extra == {"period": 7}
    assert mgr.verify_step(7) == (True, "ok")
    step, latest, _ = mgr.restore_latest(like)
    assert step == 7
    _assert_tree_equal(latest, tree)
    # a re-save of the same step swaps atomically
    mgr.save(7, _tree(seed=2))
    _assert_tree_equal(mgr.restore(7, like)[0], _tree(seed=2))
    assert mgr.all_steps() == [7]


def test_keep_prunes_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [3, 4]
    assert not os.path.exists(tmp_path / "step_0000000001")


def test_corrupt_shard_is_skipped_and_recorded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(4)})
    mgr.save(2, {"x": torch.ones(4)})
    shard = tmp_path / "step_0000000002" / "shard_0000.npz"
    data = bytearray(shard.read_bytes())
    data[-10] ^= 0xFF
    shard.write_bytes(bytes(data))
    ok, reason = mgr.verify_step(2)
    assert not ok and "checksum" in reason
    with pytest.raises(IOError, match="corrupted"):
        mgr.restore(2, {"x": torch.zeros(4)})
    step, tree, _ = mgr.restore_latest({"x": torch.full((4,), 9.0)})
    assert step == 1 and torch.equal(tree["x"], torch.zeros(4))
    assert mgr.last_skipped == [(2, reason)]


def test_missing_commit_is_not_a_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)})
    mgr.save(2, {"x": torch.ones(2)})
    os.remove(tmp_path / "step_0000000002" / "COMMIT")
    assert mgr.all_steps() == [1]
    assert mgr.verify_step(2) == (False, "no COMMIT marker")
    with pytest.raises(FileNotFoundError):
        mgr.restore(2, {"x": torch.zeros(2)})
    assert mgr.restore_latest({"x": torch.zeros(2)})[0] == 1
    # an orphaned temp dir from a crash mid-save is swept on start
    os.makedirs(tmp_path / ".tmp_crashed")
    CheckpointManager(str(tmp_path))
    assert not os.path.exists(tmp_path / ".tmp_crashed")
    empty = CheckpointManager(str(tmp_path / "none"))
    like = {"x": torch.zeros(1)}
    assert empty.restore_latest(like) == (None, like, {})


def _plain(seed):
    rng = np.random.default_rng(seed)
    return {"enc": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                    "steps": np.arange(6, dtype=np.int32)},
            "head": rng.normal(size=(4,)).astype(np.float32),
            "on": np.array([True, False])}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    want = _plain(0)
    JCheckpointManager(str(tmp_path)).save(
        3, {k: (jnp.asarray(v) if not isinstance(v, dict)
                else {kk: jnp.asarray(vv) for kk, vv in v.items()})
            for k, v in want.items()}, extra={"who": "jax"})
    like = {"enc": {"w": torch.zeros(3, 4),
                    "steps": torch.zeros(6, dtype=torch.int32)},
            "head": torch.zeros(4), "on": torch.zeros(2, dtype=torch.bool)}
    step, got, extra = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 3 and extra == {"who": "jax"}
    for name, arr in (("w", want["enc"]["w"]), ("steps", want["enc"]["steps"])):
        assert np.array_equal(got["enc"][name].numpy(), arr)
        assert got["enc"][name].dtype == like["enc"][name].dtype
    assert np.array_equal(got["head"].numpy(), want["head"])
    assert np.array_equal(got["on"].numpy(), want["on"])


def test_port_checkpoint_restores_in_jax(tmp_path):
    want = _plain(1)
    CheckpointManager(str(tmp_path)).save(
        5, {"enc": {k: torch.from_numpy(v) for k, v in want["enc"].items()},
            "head": torch.from_numpy(want["head"]),
            "on": torch.from_numpy(want["on"])}, extra={"who": "torch"})
    like = {"enc": {"w": jnp.zeros((3, 4)), "steps": jnp.zeros(6, jnp.int32)},
            "head": jnp.zeros(4), "on": jnp.zeros(2, bool)}
    step, got, extra = JCheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 5 and extra == {"who": "torch"}
    assert np.array_equal(np.asarray(got["enc"]["w"]), want["enc"]["w"])
    assert np.array_equal(np.asarray(got["enc"]["steps"]),
                          want["enc"]["steps"])
    assert np.array_equal(np.asarray(got["head"]), want["head"])
    assert np.array_equal(np.asarray(got["on"]), want["on"])
