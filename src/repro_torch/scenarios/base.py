"""Scenario-process registry: the machinery behind ``repro_torch.scenarios``.

Two kinds of process exist:

* channel and churn processes: ``step(source, state, svc) -> (state',
  svc')`` with ``init(source, n, k) -> state``; ``svc'`` keeps the (N, K)
  shapes of ``svc`` so activity stays a mask flip.  A channel process with
  ``rebuilds=True`` is handed the period's raw draws
  (``network.ServiceDraws``) instead of a built set, and builds it;
* arrival processes: episode-static samplers ``draw(source, n,
  mean_interval) -> int64 (n,)`` of non-decreasing arrival periods.

Every random number a process uses comes from a draw ``source`` (a
``Source``: ``normal``/``uniform``/``exponential`` of a named stream), and
the transition is a pure function of those draws.  The simulator's
sources are ``GeneratorSource``s seeded per episode and period; a test
hands in ``ArraySource``s holding another package's draws.

Processes are registered under string keys per kind and selected by a
hashable ``ScenarioSpec``: ``spec(name, **params)`` or the bare name.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple, Protocol

import numpy as np
import torch

KINDS = ("channel", "arrival", "churn")

# The reference package's salts of the scenario streams (folded into its
# episode or period key); here they seed the named streams below.
INIT_SALT = 1 << 30
FADING_SALT = (1 << 30) + 1
CHURN_SALT = (1 << 30) + 2
# The co-trained episode's initial model parameters: service i's from
# generator(seed + 7, COTRAIN_SALT, i), the counterpart of the reference's
# fold_in(fold_in(key, COTRAIN_SALT), i).  No other draw reads it.
COTRAIN_SALT = (1 << 30) + 4

# Every named draw stream a process may ask a source for, with the salt
# and index that seed it in a GeneratorSource.  The ``init_*`` streams are
# read from the episode's initial-state source, the rest from a period's.
STREAMS = {
    "init_shadow_service": (INIT_SALT, 0),  # gauss_markov / rayleigh z_s
    "init_shadow_client": (INIT_SALT, 1),   # gauss_markov / rayleigh z_c
    "init_fade_re": (INIT_SALT, 2),         # rayleigh_block h
    "init_fade_im": (INIT_SALT, 3),
    "init_churn": (CHURN_SALT, 0),          # gilbert's steady-state start
    "fade_re": (FADING_SALT, 0),            # rayleigh_block innovations
    "fade_im": (FADING_SALT, 1),
    "churn": (CHURN_SALT, 1),               # bernoulli / gilbert uniforms
    "gaps": (0, 0),                         # arrival gaps (exponential)
    "state0": (0, 1),                       # mmpp's first state (uniform)
    "flips": (0, 2),                        # mmpp's state flips (uniform)
}


def generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a hash of ``words``.  Every seeded draw
    of the port is made on the CPU and then moved to its device: the CPU's
    generator and a card's give different streams from one seed, so a
    generator on the card would make an episode depend on where it runs.
    SeedSequence pads ``words`` with zeros to four, so (a, b) and (a, b,
    0, 0) seed one stream: no two draws may differ only by trailing zero
    words."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


class Source(Protocol):
    """Named float32 draws of one period (or of the initial states)."""

    def normal(self, stream: str, shape) -> torch.Tensor: ...

    def uniform(self, stream: str, shape) -> torch.Tensor: ...

    def exponential(self, stream: str, shape) -> torch.Tensor: ...


def _check_stream(stream: str) -> None:
    if stream not in STREAMS:
        raise ValueError(f"unknown draw stream {stream!r}; known: "
                         f"{sorted(STREAMS)}")


class GeneratorSource:
    """Draws from one generator per stream, seeded from ``words`` and the
    stream's (salt, index), so no draw depends on which others were made.
    The draws are made on the CPU (``generator``) and moved to ``device``,
    so one seed gives the same draws on every device."""

    def __init__(self, device, *words: int):
        self.device = torch.device(device)
        self.words = words

    def _gen(self, stream: str) -> torch.Generator:
        _check_stream(stream)
        return generator(*self.words, *STREAMS[stream])

    def normal(self, stream, shape):
        return torch.randn(shape, generator=self._gen(stream)).to(self.device)

    def uniform(self, stream, shape):
        return torch.rand(shape, generator=self._gen(stream)).to(self.device)

    def exponential(self, stream, shape):
        out = torch.empty(shape, dtype=torch.float32)
        return out.exponential_(generator=self._gen(stream)).to(self.device)


class ArraySource:
    """Draws handed in as arrays, one per stream (any kind of draw reads
    its stream's array); raises on a missing stream or a shape mismatch."""

    def __init__(self, arrays: dict, device):
        self.device = torch.device(device)
        self.arrays = arrays

    def _get(self, stream, shape):
        _check_stream(stream)
        if stream not in self.arrays:
            raise KeyError(f"ArraySource holds no {stream!r} draws")
        x = torch.as_tensor(np.array(self.arrays[stream], dtype=np.float32),
                            device=self.device)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{stream!r} draws have shape {tuple(x.shape)}"
                             f", the process asked for {tuple(shape)}")
        return x

    normal = uniform = exponential = _get


class Process(NamedTuple):
    """A stateful channel or churn process.  ``rebuilds=True`` declares that
    ``step`` builds the period's ServiceSet itself from the period's raw
    draws (``network.ServiceDraws``), swapping only its channel terms."""

    init: Callable[..., Any]    # (source, n, k) -> state
    step: Callable[..., Any]    # (source, state, svc | draws) -> (state', svc')
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
