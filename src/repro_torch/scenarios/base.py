"""Scenario-process registry: the machinery behind ``repro_torch.scenarios``.

Two kinds of process exist:

* channel and churn processes: ``step(generator, state, svc) -> (state',
  svc')`` with ``init(generator, n, k) -> state``; ``svc'`` keeps the (N, K)
  shapes of ``svc`` so activity stays a mask flip;
* arrival processes: episode-static samplers ``draw(generator, n,
  mean_interval) -> int64 (n,)`` of non-decreasing arrival periods.

Processes are registered under string keys per kind and selected by a
hashable ``ScenarioSpec``: ``spec(name, **params)`` or the bare name.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple

KINDS = ("channel", "arrival", "churn")


class Process(NamedTuple):
    """A stateful channel or churn process.  ``rebuilds=True`` declares that
    ``step`` reconstructs the period's ServiceSet from its shapes alone."""

    init: Callable[..., Any]    # (generator, n, k) -> state
    step: Callable[..., Any]    # (generator, state, svc) -> (state', svc')
    rebuilds: bool = False


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Hashable (name, params) pair selecting a registered process."""

    name: str
    params: tuple[tuple[str, Any], ...] = ()

    def kwargs(self) -> dict:
        return dict(self.params)


def spec(name: str, **params) -> ScenarioSpec:
    return ScenarioSpec(name, tuple(sorted(params.items())))


def as_spec(value: str | ScenarioSpec | None, default: str) -> ScenarioSpec:
    """Normalize a SimConfig field (name, spec, or None) to a ScenarioSpec."""
    if value is None:
        return ScenarioSpec(default)
    if isinstance(value, ScenarioSpec):
        return value
    if isinstance(value, str):
        return ScenarioSpec(value)
    raise TypeError(
        f"scenario selector must be a registry key or ScenarioSpec, got "
        f"{type(value).__name__}: {value!r}")


_REGISTRIES: dict[str, dict[str, Callable[..., Any]]] = {k: {} for k in KINDS}


def register(kind: str, name: str):
    """Register a factory for ``name`` under ``kind``."""
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown scenario kind {kind!r}; expected one of {KINDS}")

    def deco(factory):
        _REGISTRIES[kind][name] = factory
        return factory

    return deco


def available(kind: str) -> tuple[str, ...]:
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown scenario kind {kind!r}; expected one of {KINDS}")
    return tuple(sorted(_REGISTRIES[kind]))


def get_process(kind: str, sp: str | ScenarioSpec, **context):
    """Build the selected process, validating the spec's parameter names.
    ``context`` (e.g. ``net``) reaches only factories that ask for it."""
    sp = as_spec(sp, default="")
    reg = _REGISTRIES[kind]
    if sp.name not in reg:
        raise ValueError(
            f"unknown {kind} process {sp.name!r}; available in repro_torch: "
            f"{available(kind)}")
    factory = reg[sp.name]
    accepted = {
        p.name for p in inspect.signature(factory).parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY)
    }
    unknown = sorted(set(sp.kwargs()) - accepted)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for {kind} process "
            f"{sp.name!r}; known parameters: {sorted(accepted - set(context))}")
    reserved = sorted(set(sp.kwargs()) & set(context))
    if reserved:
        raise ValueError(
            f"parameter(s) {reserved} of {kind} process {sp.name!r} are "
            f"supplied by the simulator and cannot be set in a spec")
    kwargs = sp.kwargs()
    kwargs.update({k: v for k, v in context.items() if k in accepted})
    return factory(**kwargs)
