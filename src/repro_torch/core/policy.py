"""Unified AllocationPolicy interface over the inter-service allocators.

    policy(svc: ServiceSet, b_total) -> (b, f)        # both (N,)

Every policy is a function of a (possibly fixed-capacity, mask-padded)
ServiceSet; an all-masked row receives b = f = 0 from every policy.
Policies are registered under string keys (``register`` / ``get_policy`` /
``available``); warm-startable variants under ``register_stateful``.

The intra-service sub-problem (Eq. 7: optimal round time + per-client
water-filling) is selectable via ``intra_backend``.  The names are the JAX
package's, so one configuration means the same in both packages:

  * ``"reference"``  -- the plain PyTorch bisection in ``core/intra``;
  * ``"pallas"``     -- in this package, the per-op CUDA kernels:
                        ``bisect_alloc`` for every f*(b), for warm ``coop``
                        one ``dual_demand`` launch per Newton trip, and for
                        ``selfish`` one ``mbdf_demand`` launch per bid book;
  * ``"megakernel"`` -- as ``"pallas"``, but ``coop``'s whole dual solve is
                        ONE ``market_clear`` launch.

The tensors' device decides between a kernel and its plain version
(``kernels.ops``): on the CPU the ``"pallas"`` and ``"megakernel"``
backends run the kernels' plain PyTorch versions.

``selfish`` (the fairness-adjusted auction) differs from the JAX package in
one dispatch: on ``"pallas"`` and ``"megakernel"`` its bids come from the
``mbdf_demand`` kernel (``mbdf_grid(backend="pallas")``), where the JAX
policy always uses the reference grid.  Under ``jit`` XLA fuses that grid
into one loop; run eagerly it is some 500 small launches per period.  The
JAX package holds the kernel to the reference grid within rtol 1e-4 /
atol 1e-5 (``tests/test_market_clear.py``).  ``"reference"`` stays the
reference grid.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple, Protocol

import torch

from repro_torch.core import auction, baselines, disba, intra
from repro_torch.core.types import BISECT_ITERS, ServiceSet
from repro_torch.kernels import ops

INTRA_BACKENDS = ("reference", "pallas", "megakernel")

class AllocationPolicy(Protocol):
    """An inter-service allocation step: (ServiceSet, B) -> (b, f)."""

    def __call__(self, svc: ServiceSet, b_total: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        ...


class StatefulPolicy(NamedTuple):
    """A policy with a fixed-shape carry threaded between periods.

    ``init_state(n, device) -> state`` builds the carry for an n-slot set
    (``()`` for stateless policies); ``step(svc, B, state) -> (b, f,
    state')`` is the per-period allocation.
    """

    init_state: Callable[..., Any]
    step: Callable[..., tuple[torch.Tensor, torch.Tensor, Any]]


# ---------------------------------------------------------------------------
# Intra-service backend selection.
# ---------------------------------------------------------------------------

def _kernel_solve(svc: ServiceSet, b: torch.Tensor, iters: int):
    """(t*, per-client split) through ``ops.intra_allocate``."""
    return ops.intra_allocate(svc.alpha, svc.t_comp, b, iters=iters)


def _intra_impl(intra_backend: str) -> str:
    """``"megakernel"`` changes only the inter-service dual solve; its
    intra-service sub-problems ride the same kernel as ``"pallas"``."""
    return "pallas" if intra_backend == "megakernel" else intra_backend


def _unknown_backend(intra_backend: str) -> ValueError:
    return ValueError(f"unknown intra backend {intra_backend!r}; "
                      f"expected one of {INTRA_BACKENDS}")


def freq_fn(intra_backend: str = "reference",
            iters: int = BISECT_ITERS) -> intra.FreqFn:
    """f*(b) with the chosen intra-service solver backend."""
    intra_backend = _intra_impl(intra_backend)
    if intra_backend == "reference":
        return lambda svc, b: intra.freq(svc, b, iters)
    if intra_backend == "pallas":

        def _freq(svc: ServiceSet, b: torch.Tensor) -> torch.Tensor:
            t_star, _ = _kernel_solve(svc, b, iters)
            # the kernel reports t* = 1/TINY for b <= 0 rows; map those to 0
            return torch.where(
                torch.logical_and(b > 0.0, t_star < 1e20),
                1.0 / torch.clamp(t_star, min=1e-30), 0.0)

        return _freq
    raise _unknown_backend(intra_backend)


def client_split_fn(intra_backend: str = "reference",
                    iters: int = BISECT_ITERS
                    ) -> Callable[[ServiceSet, torch.Tensor], torch.Tensor]:
    """Per-client water-filling split b_{n,k} with the chosen backend."""
    intra_backend = _intra_impl(intra_backend)
    if intra_backend == "reference":
        return lambda svc, b: intra.client_allocation(svc, b, iters)
    if intra_backend == "pallas":
        return lambda svc, b: _kernel_solve(svc, b, iters)[1]
    raise _unknown_backend(intra_backend)


def round_time_fn(intra_backend: str = "reference",
                  iters: int = BISECT_ITERS
                  ) -> Callable[[ServiceSet, torch.Tensor], torch.Tensor]:
    """Optimal round time t*_n(b_n) with the chosen backend ((N,) seconds;
    +inf for b <= 0 rows)."""
    intra_backend = _intra_impl(intra_backend)
    if intra_backend == "reference":
        return lambda svc, b: intra.solve_round_time(svc, b, iters)
    if intra_backend == "pallas":

        def _t(svc: ServiceSet, b: torch.Tensor) -> torch.Tensor:
            t_star, _ = _kernel_solve(svc, b, iters)
            return torch.where(torch.logical_and(b > 0.0, t_star < 1e20),
                               t_star, torch.inf)

        return _t
    raise _unknown_backend(intra_backend)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., AllocationPolicy]] = {}
_STATEFUL_REGISTRY: dict[str, Callable[..., StatefulPolicy]] = {}


def register(name: str):
    """Register a policy factory (keyword options -> allocation function)."""

    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def register_stateful(name: str):
    """Register the warm-started (carry-threading) variant of a policy."""

    def deco(factory):
        _STATEFUL_REGISTRY[name] = factory
        return factory

    return deco


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _check(name: str, unknown: dict, known: tuple[str, ...]) -> None:
    if name not in _REGISTRY:
        raise ValueError(f"unknown policy {name!r}; available: {available()}")
    if unknown:
        raise ValueError(
            f"unknown option(s) {sorted(unknown)} for policy {name!r}; "
            f"known options: {list(known)}")


def _mask_inactive_rows(svc: ServiceSet, b, f):
    active = svc.service_active()
    # EC's min-rate round time is -inf on an empty row -> clamp, then mask.
    return (torch.where(active, b, 0.0),
            torch.where(active, torch.clamp(f, min=0.0), 0.0))


def get_policy(
    name: str,
    *,
    n_bids: int = 5,
    alpha_fair: float = 0.5,
    intra_backend: str = "reference",
    iters: int = BISECT_ITERS,
    **unknown,
) -> AllocationPolicy:
    """Build the named policy, wrapped so inactive slots get b = f = 0.
    Unknown options raise a ValueError."""
    _check(name, unknown, KNOWN_OPTIONS)
    raw = _REGISTRY[name](n_bids=n_bids, alpha_fair=alpha_fair,
                          intra_backend=intra_backend, iters=iters)

    def wrapped(svc: ServiceSet, b_total):
        return _mask_inactive_rows(svc, *raw(svc, b_total))

    return wrapped


KNOWN_OPTIONS = tuple(sorted(
    p.name for p in inspect.signature(get_policy).parameters.values()
    if p.kind == inspect.Parameter.KEYWORD_ONLY))


def allocate(name: str, svc: ServiceSet, b_total, **options):
    """One-shot convenience: ``get_policy(name, **options)(svc, b_total)``."""
    return get_policy(name, **options)(svc, b_total)


def get_stateful_policy(
    name: str,
    *,
    warm_start: bool = False,
    n_bids: int = 5,
    alpha_fair: float = 0.5,
    intra_backend: str = "reference",
    iters: int = BISECT_ITERS,
    **unknown,
) -> StatefulPolicy:
    """Build the named policy in carry-threading form: the registered warm
    variant when ``warm_start`` and one exists, else the stateless policy
    with an empty carry."""
    _check(name, unknown, STATEFUL_KNOWN_OPTIONS)
    if warm_start and name in _STATEFUL_REGISTRY:
        raw = _STATEFUL_REGISTRY[name](
            n_bids=n_bids, alpha_fair=alpha_fair,
            intra_backend=intra_backend, iters=iters)

        def step(svc: ServiceSet, b_total, state):
            b, f, state = raw.step(svc, b_total, state)
            return (*_mask_inactive_rows(svc, b, f), state)

        return StatefulPolicy(init_state=raw.init_state, step=step)

    fn = get_policy(name, n_bids=n_bids, alpha_fair=alpha_fair,
                    intra_backend=intra_backend, iters=iters)

    def stateless_step(svc: ServiceSet, b_total, state):
        return (*fn(svc, b_total), state)

    return StatefulPolicy(init_state=lambda n, device=None: (),
                          step=stateless_step)


STATEFUL_KNOWN_OPTIONS = tuple(sorted(
    p.name for p in inspect.signature(get_stateful_policy).parameters.values()
    if p.kind == inspect.Parameter.KEYWORD_ONLY))


# ---------------------------------------------------------------------------
# The five paper policies.
# ---------------------------------------------------------------------------

@register("coop")
def _coop(*, intra_backend: str = "reference", iters: int = BISECT_ITERS, **_):
    """Cooperative DISBA via direct market clearing (same optimum as Alg. 1)."""
    _freq = freq_fn(intra_backend, iters)

    def fn(svc: ServiceSet, b_total):
        if intra_backend == "megakernel":
            # Cold fused clear: one launch runs 12 safeguarded-Newton trips.
            res = disba.solve_lambda_newton_warm(
                svc, b_total, disba.WARM_COLD, iters=12, inner_iters=iters,
                newton_inner_iters=iters, backend="megakernel")
            return res.b, res.f
        # the dual solve is backend-independent; only the final f*(b)
        # evaluation goes through the selected intra backend
        res = disba.solve_lambda_bisect(svc, b_total, inner_iters=iters,
                                        freq=_freq)
        return res.b, res.f

    return fn


class WarmDualState(NamedTuple):
    """Carry of warm ``coop``: the previous period's dual price and the
    running count of cold-bisection rescues."""

    lam: torch.Tensor        # () float32 dual price (WARM_COLD = no seed)
    fallbacks: torch.Tensor  # () int32 cumulative solver fallbacks


def fallback_count(pol_state) -> int:
    """Cumulative solver-fallback count carried in a policy state (0 for
    policies without one)."""
    if isinstance(pol_state, WarmDualState):
        return int(pol_state.fallbacks)
    return 0


@register_stateful("coop")
def _coop_warm(*, intra_backend: str = "reference", iters: int = BISECT_ITERS,
               **_):
    """Warm-started cooperative DISBA: the previous period's dual price seeds
    a safeguarded-Newton market clear (``disba.solve_lambda_newton_warm``)."""
    _freq = freq_fn(intra_backend, iters)
    backend = (intra_backend if intra_backend in ("pallas", "megakernel")
               else "reference")

    def init_state(n: int, device=None):
        device = torch.device("cuda") if device is None else device
        return WarmDualState(
            lam=torch.tensor(disba.WARM_COLD, dtype=torch.float32, device=device),
            fallbacks=torch.tensor(0, dtype=torch.int32, device=device))

    def step(svc: ServiceSet, b_total, state):
        # megakernel emits f from the same launch; the other backends
        # evaluate the final f*(b) once, through the selected intra backend.
        res = disba.solve_lambda_newton_warm(
            svc, b_total, state.lam, inner_iters=iters, backend=backend,
            freq=_freq)
        # Only carry the price out of periods that cleared a market.
        lam_next = torch.where(torch.any(svc.service_active()), res.lam,
                               state.lam)
        fallbacks = state.fallbacks + torch.as_tensor(
            res.fallback, dtype=torch.int32, device=svc.device)
        return res.b, res.f, WarmDualState(lam=lam_next, fallbacks=fallbacks)

    return StatefulPolicy(init_state=init_state, step=step)


@register("selfish")
def _selfish(*, n_bids: int = 5, alpha_fair: float = 0.5,
             intra_backend: str = "reference", iters: int = BISECT_ITERS, **_):
    """Fairness-adjusted multi-bid auction with truthful uniform bids
    (§V.E).  The kernel backends build the bids with ``mbdf_demand`` (see
    the module docstring) and evaluate f*(b) with ``bisect_alloc``."""
    _freq = freq_fn(intra_backend, iters)
    grid = "reference" if intra_backend == "reference" else "pallas"

    def fn(svc: ServiceSet, b_total):
        bid = auction.uniform_truthful_bids(svc, n_bids, alpha_fair,
                                            iters=iters, backend=grid)
        b, _ = auction.allocate(bid, b_total)
        return b, _freq(svc, b)

    return fn


@register("ec")
def _ec(**_):
    """Equal-Client benchmark: uniform per-client bandwidth, no intra solve."""

    def fn(svc: ServiceSet, b_total):
        return baselines.equal_client(svc, b_total)

    return fn


@register("es")
def _es(*, intra_backend: str = "reference", iters: int = BISECT_ITERS, **_):
    """Equal-Service benchmark: B / N_active each, optimal intra split."""
    _freq = freq_fn(intra_backend, iters)

    def fn(svc: ServiceSet, b_total):
        return baselines.equal_service(svc, b_total, freq=_freq)

    return fn


@register("pp")
def _pp(*, intra_backend: str = "reference", iters: int = BISECT_ITERS, **_):
    """Proportional benchmark: B * K_n / sum K, optimal intra split."""
    _freq = freq_fn(intra_backend, iters)

    def fn(svc: ServiceSet, b_total):
        return baselines.proportional(svc, b_total, freq=_freq)

    return fn
