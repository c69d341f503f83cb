"""Tree checkpointing with crash-safe, verifiable steps.

Layout:  <dir>/step_<N>/
            meta.json          # leaf names, shard index, checksums, extra
            shard_<i>.npz      # flat leaves, chunked to ~512MB per shard
            COMMIT             # written LAST -> presence marks completeness

The layout, the leaf names (the reference package's key paths,
``tree.leaves_with_names``) and the meta keys are the reference package's,
so a checkpoint of a tree of plain dicts of arrays written by either
package restores in the other, bitwise.

A checkpoint is valid iff COMMIT exists and every shard matches the sha256
recorded in ``meta.json``.  Writes go to a temp dir that is fsynced
(shards, meta, COMMIT, then the directory) and renamed into place; a
re-save of an existing step swaps atomically.  ``restore_latest`` walks
newest to oldest and skips any step that fails verification (recorded in
``last_skipped``).  ``keep`` bounds retention.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_lib

_COMMIT = "COMMIT"
_SHARD_BYTES = 512 * 1024 * 1024


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (bfloat16, which numpy lacks, as float32:
    exact, and cast back on restore)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def _describe(tree) -> str:
    """A readable outline of the tree's structure for meta.json (the
    reference package writes its own treedef string there; neither
    package reads it back)."""
    if tree is None:
        return "None"
    children = tree_lib._children(tree)
    if children is None:
        return "*"
    inner = ", ".join(f"{suffix}: {_describe(child)}"
                      for suffix, child in children)
    return f"{type(tree).__name__}({inner})"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _like_leaf(ref, arr: np.ndarray):
    """``arr`` in the dtype (and, for a tensor, on the device) of
    ``ref``."""
    if torch.is_tensor(ref):
        out = torch.from_numpy(np.array(arr))
        return out.to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr).astype(ref.dtype if hasattr(ref, "dtype")
                                  else arr.dtype)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        # Steps restore_latest had to skip, refreshed on every call.
        self.last_skipped: list[tuple[int, str]] = []
        # A crash mid-save leaves an orphaned temp dir: sweep them.
        for name in os.listdir(self.directory):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, _COMMIT)):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        named = tree_lib.leaves_with_names(tree)
        final_dir = self._step_dir(step)
        tmp_dir = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            shards: list[list[tuple[str, np.ndarray]]] = [[]]
            size = 0
            for name, leaf in named:
                arr = _host(leaf)
                if size + arr.nbytes > _SHARD_BYTES and shards[-1]:
                    shards.append([])
                    size = 0
                shards[-1].append((name, arr))
                size += arr.nbytes
            index, checksums = {}, {}
            for i, shard in enumerate(shards):
                fname = f"shard_{i:04d}.npz"
                fpath = os.path.join(tmp_dir, fname)
                np.savez(fpath, **{n: a for n, a in shard})
                _fsync_path(fpath)
                checksums[fname] = _sha256(fpath)
                for n, _ in shard:
                    index[n] = fname
            meta = {"step": step, "treedef": _describe(tree),
                    "leaf_names": [n for n, _ in named], "index": index,
                    "shard_checksums": checksums, "extra": extra or {}}
            meta_path = os.path.join(tmp_dir, "meta.json")
            with open(meta_path, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            # the commit marker last; it and the directory durable before
            # the rename makes the step visible
            commit_path = os.path.join(tmp_dir, _COMMIT)
            with open(commit_path, "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            _fsync_path(tmp_dir)
            if os.path.exists(final_dir):
                # re-save of an existing step: rename the old one aside,
                # the new one in, then drop the old (never a window with
                # no checkpoint at this step)
                aside = final_dir + ".old"
                shutil.rmtree(aside, ignore_errors=True)
                os.rename(final_dir, aside)
                os.rename(tmp_dir, final_dir)
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.rename(tmp_dir, final_dir)
            _fsync_path(self.directory)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self._prune()
        return final_dir

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def verify_step(self, step: int) -> tuple[bool, str]:
        """COMMIT present, meta.json parseable, every indexed shard present
        and matching its sha256 (a checkpoint without checksums: every
        shard loads and holds its indexed leaves)."""
        step_dir = self._step_dir(step)
        if not os.path.exists(os.path.join(step_dir, _COMMIT)):
            return False, "no COMMIT marker"
        try:
            with open(os.path.join(step_dir, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as exc:
            return False, f"unreadable meta.json ({exc})"
        checksums = meta.get("shard_checksums")
        for fname in sorted(set(meta.get("index", {}).values())):
            fpath = os.path.join(step_dir, fname)
            if not os.path.exists(fpath):
                return False, f"missing shard {fname}"
            if checksums is not None:
                if _sha256(fpath) != checksums.get(fname):
                    return False, f"checksum mismatch on {fname}"
            else:
                try:
                    with np.load(fpath) as payload:
                        names = set(payload.files)
                    for leaf, shard in meta["index"].items():
                        if shard == fname and leaf not in names:
                            return False, f"shard {fname} missing leaf {leaf}"
                except Exception as exc:
                    return False, f"unloadable shard {fname} ({exc})"
        return True, "ok"

    def restore(self, step: int, like):
        """(tree, extra): the step's leaves in the structure of ``like``,
        each in its ``like`` leaf's dtype and, for a tensor, on its device.
        Raises on a missing or corrupted step."""
        step_dir = self._step_dir(step)
        if not os.path.exists(os.path.join(step_dir, _COMMIT)):
            raise FileNotFoundError(f"no complete checkpoint at step {step}")
        ok, reason = self.verify_step(step)
        if not ok:
            raise IOError(f"checkpoint at step {step} is corrupted: {reason}")
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        cache: dict[str, Any] = {}

        def load(name: str) -> np.ndarray:
            fname = meta["index"][name]
            if fname not in cache:
                cache[fname] = np.load(os.path.join(step_dir, fname))
            return cache[fname][name]

        named_like = tree_lib.leaves_with_names(like)
        values = [_like_leaf(ref, load(name)) for name, ref in named_like]
        return tree_lib.unflatten(like, values), meta["extra"]

    def restore_latest(self, like):
        """(step, tree, extra) from the newest verifiable checkpoint, or
        (None, like, {}) when none survives.  A committed but corrupted
        step is skipped and recorded in ``last_skipped`` as (step,
        reason)."""
        self.last_skipped = []
        for step in reversed(self.all_steps()):
            ok, reason = self.verify_step(step)
            if not ok:
                self.last_skipped.append((step, reason))
                continue
            tree, extra = self.restore(step, like)
            return step, tree, extra
        return None, like, {}
