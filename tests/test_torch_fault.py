"""The port's fault-tolerance layer (``repro_torch.distributed.fault``)
against the JAX package's.

``resumable_loop`` wraps the same deterministic step in both packages;
a crash at the same step under either fail phase must re-execute the
same steps on resume (the replay bound), and the resumed run must land
bitwise on the uninterrupted one.  The two packages' float32 arithmetic
may differ by XLA's fusion, so across packages the final states are held
within rtol 1e-6 and the step logs exactly.  Also: the unknown phase
raises, the default policy is not shared, and no function default under
``src/repro_torch`` is a shared mutable instance.
"""
import dataclasses
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.distributed import fault as j_fault
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import fault

N_STEPS, SAVE_EVERY = 10, 3


def _torch_step(log):
    def step(state, t):
        log.append(t)
        return state * torch.tensor(1.0001) + torch.tensor(float(t))
    return step


def _jax_step(log):
    def step(state, t):
        log.append(t)
        return state * jnp.float32(1.0001) + jnp.float32(t)
    return step


def _crash_and_resume(pkg, manager, path, step_fn, init, fail_at, phase):
    """(steps run before the crash, steps run after it, final state)."""
    mgr = manager(path)
    policy = pkg.RestartPolicy(save_every=SAVE_EVERY)
    before, after = [], []
    with pytest.raises(RuntimeError, match="injected"):
        pkg.resumable_loop(step_fn(before), init, N_STEPS, mgr, policy,
                           fail_at=fail_at, fail_phase=phase)
    final = pkg.resumable_loop(step_fn(after), init, N_STEPS, mgr, policy)
    return before, after, final


@pytest.mark.parametrize("fail_at,phase,replayed", [
    (7, "pre_step", [6]),        # off-boundary: newest checkpoint at 6
    (6, "pre_step", []),         # on-boundary: nothing replayed
    (5, "post_step", [3, 4, 5]),  # the torn-write window: step 5 ran
])
def test_resumable_loop_replay_bound_matches_reference(tmp_path, fail_at,
                                                       phase, replayed):
    clean_log = []
    clean = fault.resumable_loop(
        _torch_step(clean_log), torch.tensor(1.0), N_STEPS,
        CheckpointManager(str(tmp_path / "clean")),
        fault.RestartPolicy(save_every=SAVE_EVERY))
    assert clean_log == list(range(N_STEPS))
    got = _crash_and_resume(fault, CheckpointManager, str(tmp_path / "t"),
                            _torch_step, torch.tensor(1.0), fail_at, phase)
    want = _crash_and_resume(j_fault, JManager, str(tmp_path / "j"),
                             _jax_step, jnp.float32(1.0), fail_at, phase)
    assert got[0] == want[0] == list(range(fail_at + (phase == "post_step")))
    assert got[1] == want[1]
    # re-executed: the steps before the crash (and, past the step, the
    # crashing step itself)
    done = fail_at + (phase == "post_step")
    assert [t for t in got[1] if t < done] == replayed
    assert len(replayed) <= SAVE_EVERY - (phase == "pre_step")
    # resumed == uninterrupted, bit for bit; and the reference's value
    assert torch.equal(got[2], clean)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_resumable_loop_rejects_unknown_fail_phase(tmp_path):
    with pytest.raises(ValueError, match="fail_phase"):
        fault.resumable_loop(_torch_step([]), torch.tensor(1.0), 2,
                             CheckpointManager(str(tmp_path / "x")),
                             fail_at=1, fail_phase="mid_step")


def test_restart_policy_default_not_shared():
    default = inspect.signature(fault.resumable_loop).parameters["policy"]
    assert default.default is None
    assert fault.RestartPolicy() is not fault.RestartPolicy()
    assert dataclasses.asdict(fault.RestartPolicy()) == dataclasses.asdict(
        j_fault.RestartPolicy())


def _is_mutable_default(value) -> bool:
    if isinstance(value, (list, dict, set, bytearray)):
        return True
    return (dataclasses.is_dataclass(value) and not isinstance(value, type)
            and not type(value).__dataclass_params__.frozen)


def _port_callables():
    import repro_torch
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        mod = importlib.import_module(info.name)
        for _, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ == info.name:
                yield fn
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ != info.name or dataclasses.is_dataclass(cls):
                continue
            for _, fn in inspect.getmembers(cls, inspect.isfunction):
                if fn.__qualname__.startswith(cls.__name__):
                    yield fn


def test_no_mutable_defaults_under_src_repro_torch():
    """No function or method of the port defaults an argument to a shared
    mutable instance (the audit behind ``resumable_loop``'s in-body
    default).  Every module of the package must import here."""
    offenders, scanned = [], 0
    for fn in _port_callables():
        scanned += 1
        try:
            sig = inspect.signature(fn)
        except (ValueError, TypeError):
            continue
        for name, param in sig.parameters.items():
            if param.default is not inspect.Parameter.empty and \
                    _is_mutable_default(param.default):
                offenders.append(f"{fn.__module__}.{fn.__qualname__}({name})")
    assert scanned > 200, "audit walked suspiciously few callables"
    assert not offenders, f"mutable defaults found: {offenders}"
