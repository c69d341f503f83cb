"""DISBA: Distributed Inter-Service Bandwidth Allocation (paper §IV, Alg. 1).

Maximize  sum_n log(1 + f*_n(b_n))  s.t.  sum_n b_n = B   (Eq. 2)

via dual decomposition: each provider answers the price lam with its demand
b*_n(lam) (Eq. 12-14, ``intra``), and the operator updates the price.

Solvers:

  * ``disba``        -- the paper's subgradient loop (Algorithm 1), a Python
                        ``while`` that reads the stopping test on the host.
  * ``disba_trace``  -- the same iteration recording per-iteration history.
  * ``solve_lambda_bisect`` / ``solve_lambda_newton`` /
    ``solve_lambda_newton_warm`` -- market clearing by bisection or by
                        safeguarded Newton on the monotone aggregate demand,
                        the latter seeded from the previous period's price.
  * ``disba_sharded`` -- the market clear with the services split over the
                        ranks of a mesh: each rank solves its residents'
                        inner problems, and the only traffic between ranks
                        is a scalar reduction of demand per dual trip --
                        Algorithm 1's operator<->provider pattern (and its
                        privacy: client-level alpha/t_comp never leave the
                        rank that holds them).

Every solver keeps its price iterate as a float32 tensor on the set's
device; only ``disba``'s stopping test and the warm solver's non-finite
rescue wait on the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import intra
from repro_torch.core.types import BISECT_ITERS, ServiceSet
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib

_TINY = 1e-30


def _final_freq(freq: intra.FreqFn | None, svc: ServiceSet,
                b: torch.Tensor, inner_iters: int) -> torch.Tensor:
    """f*(b) through ``freq`` (an intra backend's solver), or the plain
    ``intra.freq`` when none is given."""
    return intra.freq(svc, b, inner_iters) if freq is None else freq(svc, b)


class DisbaResult(NamedTuple):
    b: torch.Tensor           # (N,) allocated bandwidth
    f: torch.Tensor           # (N,) resulting FL frequency
    lam: torch.Tensor         # () final dual price
    iterations: torch.Tensor  # () iterations used
    converged: torch.Tensor   # () bool
    # () bool: True when the warm solver met non-finite inputs or outputs
    # and served the cold-bisection rescue instead.
    fallback: torch.Tensor | bool = False


def _scalar(x, svc: ServiceSet, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=svc.device)


def sanitize_service_set(svc: ServiceSet) -> tuple[ServiceSet, torch.Tensor]:
    """(cleaned set, poisoned?) -- non-finite alpha/t_comp entries are masked
    out and zeroed, as ``types.mask_clients`` drops a client, so the rescue
    solves the set without them; ``poisoned`` is True iff a masked-in entry
    was non-finite.

    The JAX package writes 1.0 into those slots instead; its ``intra.demand``
    then meets a masked slot with t^C != 0, underflows (1 - t^C f)^2 to 0
    and starves the service (ROADMAP C2, C8), so the two rescues differ on
    a partly poisoned row."""
    ok = torch.logical_and(torch.isfinite(svc.alpha), torch.isfinite(svc.t_comp))
    poisoned = torch.any(torch.logical_and(svc.mask, ~ok))
    clean = ServiceSet(
        alpha=torch.where(ok, svc.alpha, 0.0),
        t_comp=torch.where(ok, svc.t_comp, 0.0),
        mask=torch.logical_and(svc.mask, ok),
    )
    return clean, poisoned


def objective(svc: ServiceSet, b: torch.Tensor) -> torch.Tensor:
    """The proportional-fairness objective sum_n log(1 + f*_n(b_n))."""
    return torch.sum(torch.log1p(intra.freq(svc, b)))


def _project(b: torch.Tensor, b_total: float) -> torch.Tensor:
    """Scale demands onto the simplex sum b = B."""
    return b * (b_total / torch.clamp(torch.sum(b), min=_TINY))


# ---------------------------------------------------------------------------
# Paper-faithful subgradient loop (Algorithm 1).
# ---------------------------------------------------------------------------

def disba(
    svc: ServiceSet,
    total_bandwidth: float,
    gamma: float = 0.1,
    eps: float = 1e-3,
    lam0: float | None = None,
    max_iters: int = 10_000,
    inner_iters: int = BISECT_ITERS,
    diminishing: bool = False,
) -> DisbaResult:
    """Algorithm 1 with the unit-invariant step

        lam_hat <- proj_[0,1] ( lam_hat - gamma * (1 - D/B) ),  lam = lam_hat * p_bar

    with p_bar = max_n p_max_n.  ``diminishing=True`` uses
    gamma_j = gamma / sqrt(j + 1).  Each iteration's stopping test reads
    |lam_j - lam_{j-1}| on the host.
    """
    lam_scale = torch.amax(intra.p_max(svc))
    lam = (0.5 * lam_scale if lam0 is None else _scalar(lam0, svc))
    lam_prev = lam
    j = 0
    first = True
    while j < max_iters and (
            first or bool(torch.abs(lam - lam_prev) > eps * lam_scale)):
        grad = 1.0 - torch.sum(intra.demand(svc, lam, inner_iters)) / total_bandwidth
        step = (gamma * torch.rsqrt(_scalar(1.0 + j, svc)) if diminishing
                else _scalar(gamma, svc))
        lam_prev, lam = lam, torch.minimum(
            torch.clamp(lam - step * lam_scale * grad, min=0.0), lam_scale)
        j += 1
        first = False
    b = _project(intra.demand(svc, lam, inner_iters), total_bandwidth)
    return DisbaResult(
        b=b,
        f=intra.freq(svc, b, inner_iters),
        lam=lam,
        iterations=_scalar(j, svc, torch.int32),
        converged=torch.abs(lam - lam_prev) <= eps * lam_scale,
    )


def disba_trace(
    svc: ServiceSet,
    total_bandwidth: float,
    gamma: float = 0.1,
    eps: float = 1e-3,
    lam0: float | None = None,
    max_iters: int = 10_000,
    diminishing: bool = False,
) -> dict:
    """Algorithm 1 with the price kept as a Python float, recording the
    per-iteration history (Figs. 4-5, Table II)."""
    lam_scale = float(torch.amax(intra.p_max(svc)))
    lam = 0.5 * lam_scale if lam0 is None else float(lam0)
    hist = {"lam": [], "b": [], "f": [], "demand_gap": []}
    j = 0
    converged = False
    while j < max_iters:
        b = intra.demand(svc, _scalar(lam, svc))
        hist["lam"].append(lam)
        hist["b"].append(b)
        hist["f"].append(intra.freq(svc, b))
        gap = float(total_bandwidth - torch.sum(b))
        hist["demand_gap"].append(gap)
        step = gamma / (1.0 + j) ** 0.5 if diminishing else gamma
        lam_next = min(max(lam - step * lam_scale * gap / total_bandwidth, 0.0),
                       lam_scale)
        lam_prev, lam = lam, lam_next
        j += 1
        if abs(lam - lam_prev) <= eps * lam_scale:
            converged = True
            break
    hist["iterations"] = j
    hist["converged"] = converged
    b_last = intra.demand(svc, _scalar(lam, svc))
    hist["b_final"] = b_last * (total_bandwidth / torch.sum(b_last))
    hist["f_final"] = intra.freq(svc, hist["b_final"])
    return hist


# ---------------------------------------------------------------------------
# Market clearing by bisection / Newton.
# ---------------------------------------------------------------------------

def solve_lambda_bisect(
    svc: ServiceSet,
    total_bandwidth: float,
    iters: int = BISECT_ITERS,
    inner_iters: int = BISECT_ITERS,
    freq: intra.FreqFn | None = None,
) -> DisbaResult:
    """Root of D(lam) - B on (0, max_n p_max) by bisection: D is strictly
    decreasing.  The final f*(b) goes through ``freq`` when given."""
    lam_hi = torch.amax(intra.p_max(svc))

    def h(lam):
        return torch.sum(intra.demand(svc, lam, inner_iters)) - total_bandwidth

    lam = intra._bisect(h, torch.zeros_like(lam_hi), lam_hi, iters)
    b = _project(intra.demand(svc, lam, inner_iters), total_bandwidth)
    return DisbaResult(
        b=b, f=_final_freq(freq, svc, b, inner_iters), lam=lam,
        iterations=_scalar(iters, svc, torch.int32),
        converged=_scalar(True, svc, torch.bool),
    )


def demand_slope_values(svc: ServiceSet, lam, inner_iters: int = BISECT_ITERS):
    """Per-service (b(lam), db/dlam) in closed form.

    From Eq. 13, lam = psi(f) = f'(b(f))/(1+f); db/dlam = b'(f)/psi'(f) with
    b'(f) = 1/f'(b) (Eq. 8) and psi'(f) = (f''*(1+f)/f' - f') / (1+f)^2.
    Opted-out providers (f = 0) contribute zero slope.
    """
    f = intra.freq_from_price(svc, lam, inner_iters)
    b = intra.bandwidth_from_freq(svc, f)
    fp = torch.clamp(intra.freq_prime_at_f(svc, f), min=_TINY)
    fpp = intra.freq_second_at_f(svc, f)
    psi_p = (fpp * (1.0 + f) / fp - fp) / (1.0 + f) ** 2
    slope = torch.where(f > 0.0, (1.0 / fp) / psi_p, 0.0)
    return b, slope


def _demand_and_slope(svc: ServiceSet, lam, inner_iters: int):
    """(D(lam), dD/dlam, b(lam)) -- the aggregates a dual iteration needs."""
    b, slope = demand_slope_values(svc, lam, inner_iters)
    return torch.sum(b), torch.sum(slope), b


def solve_lambda_newton(
    svc: ServiceSet,
    total_bandwidth: float,
    iters: int = 12,
    inner_iters: int = BISECT_ITERS,
) -> DisbaResult:
    """Cold safeguarded Newton: the midpoint seed and the full inner trip
    count in every Newton iteration."""
    return solve_lambda_newton_warm(
        svc, total_bandwidth, WARM_COLD, iters=iters,
        inner_iters=inner_iters, newton_inner_iters=inner_iters,
    )


# ---------------------------------------------------------------------------
# Warm-started market clearing: the fast path of the multi-period simulator.
# ---------------------------------------------------------------------------

WARM_COLD = -1.0   # dual-price sentinel meaning "no previous solve to reuse"
WARM_ITERS = 6     # safeguarded-Newton trips from a warm seed
WARM_INNER_ITERS = 24  # inner price->frequency trips inside the Newton loop;
                       # the final demand/frequency still run ``inner_iters``

# In this package ``"pallas"`` names the per-op CUDA kernels (one
# ``dual_demand`` launch per trip) and ``"megakernel"`` the one-launch
# ``market_clear`` kernel; the names match the JAX package's so one
# configuration means the same in both.
DEMAND_BACKENDS = ("reference", "pallas", "megakernel")


def _demand_slope_backend(svc: ServiceSet, lam, inner_iters: int, backend: str):
    """(D(lam), dD/dlam, b(lam)) through the selected demand backend."""
    if backend == "reference":
        return _demand_and_slope(svc, lam, inner_iters)
    if backend == "pallas":
        b, slope = ops.dual_demand(svc.alpha, svc.t_comp, svc.mask, lam,
                                   iters=inner_iters)
        return torch.sum(b), torch.sum(slope), b
    raise ValueError(f"unknown demand backend {backend!r}; "
                     f"expected one of {DEMAND_BACKENDS}")


def solve_lambda_newton_warm(
    svc: ServiceSet,
    total_bandwidth: float,
    lam_prev: torch.Tensor | float = WARM_COLD,
    iters: int = WARM_ITERS,
    inner_iters: int = BISECT_ITERS,
    newton_inner_iters: int = WARM_INNER_ITERS,
    backend: str = "reference",
    freq: intra.FreqFn | None = None,
) -> DisbaResult:
    """Safeguarded Newton on D(lam) - B = 0, seeded from ``lam_prev``.

    The bracket [0, max_n p_max] safeguards every step; ``lam_prev <= 0``
    (the ``WARM_COLD`` sentinel) or a seed at/above the bracket top starts
    from the midpoint.  ``backend``: ``"reference"`` (PyTorch ops),
    ``"pallas"`` (one ``dual_demand`` kernel launch per trip) or
    ``"megakernel"`` (the whole solve as one ``market_clear`` launch, which
    also emits f).  Otherwise the final f*(b) goes through ``freq`` when
    given, else ``intra.freq``.

    Non-finite hardening: NaN/Inf in the masked-in service tensors, a
    non-finite seed, or a non-finite result triggers a cold-bisection rescue
    on the sanitized set, flagged in ``DisbaResult.fallback``.  The test is a
    host ``if``: one device-to-host sync per solve.
    """
    if backend not in DEMAND_BACKENDS:
        raise ValueError(f"unknown demand backend {backend!r}; "
                         f"expected one of {DEMAND_BACKENDS}")
    lam_prev = _scalar(lam_prev, svc)
    svc_clean, poisoned = sanitize_service_set(svc)
    if backend == "megakernel":
        b, f, lam = ops.market_clear(
            svc.alpha, svc.t_comp, svc.mask, total_bandwidth, lam_prev,
            iters=iters, inner_iters=inner_iters,
            newton_inner_iters=newton_inner_iters)
    else:
        lam_hi0 = torch.amax(intra.p_max(svc))
        warm_ok = torch.logical_and(lam_prev > 0.0, lam_prev < lam_hi0)
        lam = torch.where(warm_ok, lam_prev, 0.5 * lam_hi0)
        lo, hi = torch.zeros_like(lam_hi0), lam_hi0
        for _ in range(iters):
            d, slope, _ = _demand_slope_backend(svc, lam, newton_inner_iters,
                                                backend)
            resid = d - total_bandwidth
            lo = torch.where(resid > 0, lam, lo)  # demand too high: raise price
            hi = torch.where(resid > 0, hi, lam)
            step = resid / torch.where(torch.abs(slope) > _TINY, slope, -_TINY)
            lam_newton = lam - step
            # Non-strict bounds: a converged iterate reproduces itself.
            in_bracket = torch.logical_and(lam_newton >= lo, lam_newton <= hi)
            lam = torch.where(in_bracket, lam_newton, 0.5 * (lo + hi))
        if backend == "reference":
            b = intra.demand(svc, lam, inner_iters)
        else:
            _, _, b = _demand_slope_backend(svc, lam, inner_iters, backend)
        b = _project(b, total_bandwidth)
        f = _final_freq(freq, svc, b, inner_iters)

    out_finite = torch.logical_and(
        torch.isfinite(lam),
        torch.logical_and(torch.all(torch.isfinite(b)),
                          torch.all(torch.isfinite(f))))
    bad = torch.logical_or(poisoned, torch.logical_or(~torch.isfinite(lam_prev),
                                                      ~out_finite))
    if bool(bad):
        lam_hi = torch.amax(intra.p_max(svc_clean))

        def h(lam_r):
            return (torch.sum(intra.demand(svc_clean, lam_r, inner_iters))
                    - total_bandwidth)

        lam = intra._bisect(h, torch.zeros_like(lam_hi), lam_hi, BISECT_ITERS)
        b = _project(intra.demand(svc_clean, lam, inner_iters), total_bandwidth)
        f = intra.freq(svc_clean, b, inner_iters)
    return DisbaResult(
        b=b, f=f, lam=lam, iterations=_scalar(iters, svc, torch.int32),
        converged=_scalar(True, svc, torch.bool), fallback=bad,
    )


# ---------------------------------------------------------------------------
# Distributed DISBA: services split over the ranks of a mesh.
# ---------------------------------------------------------------------------

SHARDED_METHODS = ("bisect", "newton")


def disba_sharded(
    mesh: mesh_lib.Mesh | None,
    svc: ServiceSet,
    total_bandwidth: float,
    axis_names: tuple[str, ...] = ("data",),
    iters: int = BISECT_ITERS,
    inner_iters: int = BISECT_ITERS,
    method: str = "bisect",
    lam_prev: torch.Tensor | float = WARM_COLD,
    newton_inner_iters: int = WARM_INNER_ITERS,
    demand_backend: str = "reference",
) -> DisbaResult:
    """Market-clearing DISBA with the service axis split over the ranks of
    ``axis_names``.

    Every rank passes the whole set and gets the whole ``b`` and ``f``
    back; it solves only its contiguous block of rows (block index
    row-major over ``axis_names``), and the ranks exchange a scalar
    reduction per dual trip.  N must divide by the product of the axis
    sizes: pad with all-masked rows, which demand exactly zero bandwidth
    and so never move the clearing price.

    ``method="bisect"`` runs the cold dual bisection, ``iters`` trips of
    one scalar demand all-reduce each.  ``method="newton"`` runs the
    safeguarded Newton of ``solve_lambda_newton_warm``, ``iters`` trips
    seeded from ``lam_prev``: each trip evaluates the rank's demand and
    slope (``demand_backend="reference"``, PyTorch ops, or ``"pallas"``,
    one ``dual_demand`` launch on the rank's rows) and all-reduces the
    (demand, slope) pair once; the price update is replicated.  The final
    demand and frequency are the plain ``intra.demand`` / ``intra.freq``,
    as in the JAX package; a multi-axis ``axis_names`` reduces once per
    axis.

    ``mesh=None`` builds a one-axis mesh over the world through
    ``launch.mesh.flat_mesh`` -- the same path as ``fl.simulator.run_fleet``
    (requires ``len(axis_names) == 1``).  Without a process group the
    world is one rank and every reduction is the identity.
    """
    if method not in SHARDED_METHODS:
        raise ValueError(f"unknown method {method!r}; "
                         f"expected one of {SHARDED_METHODS}")
    if demand_backend not in ("reference", "pallas"):
        raise ValueError(f"unknown demand backend {demand_backend!r}; "
                         f"expected 'reference' or 'pallas'")
    if mesh is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"mesh=None builds a one-axis mesh; pass an explicit mesh "
                f"for multi-axis sharding over {axis_names}")
        mesh = mesh_lib.flat_mesh(axis_name=axis_names[0])
    n_shards = math.prod(mesh.shape[ax] for ax in axis_names)
    if svc.n_services % n_shards:
        raise ValueError(
            f"{svc.n_services} services do not split over the {n_shards} "
            f"ranks of {axis_names}: pad the set with all-masked rows")
    block = 0
    for ax in axis_names:
        block = block * mesh.shape[ax] + mesh.coordinate(ax)
    rows = svc.n_services // n_shards
    lo = block * rows
    local = ServiceSet(alpha=svc.alpha[lo:lo + rows],
                       t_comp=svc.t_comp[lo:lo + rows],
                       mask=svc.mask[lo:lo + rows])

    def reduce(x, op="sum"):
        return collectives.all_reduce(x, mesh, axis_names, op)

    lam_hi = reduce(torch.amax(intra.p_max(local)), "max")
    if method == "bisect":
        def h(lam):
            d = reduce(torch.sum(intra.demand(local, lam, inner_iters)))
            return d - total_bandwidth

        lam = intra._bisect(h, torch.zeros_like(lam_hi), lam_hi, iters)
    else:
        lam_seed = _scalar(lam_prev, local)
        warm_ok = torch.logical_and(lam_seed > 0.0, lam_seed < lam_hi)
        lam = torch.where(warm_ok, lam_seed, 0.5 * lam_hi)
        lo_lam, hi_lam = torch.zeros_like(lam_hi), lam_hi
        for _ in range(iters):
            if demand_backend == "pallas":
                b_l, s_l = ops.dual_demand(local.alpha, local.t_comp,
                                           local.mask, lam,
                                           iters=newton_inner_iters)
            else:
                b_l, s_l = demand_slope_values(local, lam, newton_inner_iters)
            # ONE collective per trip: the (demand, slope) pair.
            d, slope = reduce(torch.stack([torch.sum(b_l), torch.sum(s_l)]))
            resid = d - total_bandwidth
            lo_lam = torch.where(resid > 0, lam, lo_lam)
            hi_lam = torch.where(resid > 0, hi_lam, lam)
            step = resid / torch.where(torch.abs(slope) > _TINY, slope, -_TINY)
            lam_newton = lam - step
            in_bracket = torch.logical_and(lam_newton >= lo_lam,
                                           lam_newton <= hi_lam)
            lam = torch.where(in_bracket, lam_newton, 0.5 * (lo_lam + hi_lam))
    b = intra.demand(local, lam, inner_iters)
    b = b * (total_bandwidth / torch.clamp(reduce(torch.sum(b)), min=_TINY))
    f = intra.freq(local, b, inner_iters)
    return DisbaResult(
        b=collectives.all_gather_rows(b, mesh, axis_names),
        f=collectives.all_gather_rows(f, mesh, axis_names),
        lam=lam, iterations=_scalar(iters, svc, torch.int32),
        converged=_scalar(True, svc, torch.bool),
    )
