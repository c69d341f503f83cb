"""Fault tolerance: checkpoint/restart policy and failure injection.

``resumable_loop`` wraps any step function with auto-resume from the
newest complete checkpoint (``repro_torch.checkpoint``'s COMMIT protocol):
a restarted job loses at most ``save_every - 1`` steps, and, since the
step is deterministic (a batch or a period's draws are a function of
(seed, step)), the replayed trajectory is bit-identical to an
uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class RestartPolicy:
    save_every: int = 50
    keep: int = 3


def resumable_loop(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    manager: CheckpointManager,
    policy: RestartPolicy | None = None,
    fail_at: int | None = None,
    fail_phase: str = "pre_step",
):
    """Run ``state = step_fn(state, t)`` for t in [0, n_steps), checkpointing
    every ``policy.save_every`` steps and auto-resuming from the newest
    complete checkpoint.

    ``fail_at`` injects a crash (tests).  ``fail_phase`` picks where in the
    step it lands: ``"pre_step"`` before ``step_fn`` runs, ``"post_step"``
    after the step but before any ``manager.save``, the torn-write window
    the COMMIT protocol closes (the completed step's state dies with the
    process, so resume replays it from the last checkpoint; the loss bound
    is still at most ``save_every`` steps of work).
    """
    # In the body, not the signature: a default instance there would be
    # one object shared (and mutable) by every caller.
    if policy is None:
        policy = RestartPolicy()
    if fail_phase not in ("pre_step", "post_step"):
        raise ValueError(f"unknown fail_phase {fail_phase!r}")
    start_step, state, _ = manager.restore_latest(init_state)
    t0 = 0 if start_step is None else start_step
    state = init_state if start_step is None else state
    for t in range(t0, n_steps):
        if fail_at is not None and t == fail_at and fail_phase == "pre_step":
            raise RuntimeError(f"injected failure at step {t}")
        state = step_fn(state, t)
        if fail_at is not None and t == fail_at and fail_phase == "post_step":
            raise RuntimeError(
                f"injected failure after step {t} (pre-commit)")
        if (t + 1) % policy.save_every == 0 or t + 1 == n_steps:
            manager.save(t + 1, state)
    return state
