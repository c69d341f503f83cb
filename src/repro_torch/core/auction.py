"""Fairness-adjusted multi-bid auction (paper §V.A-§V.E).

Each provider n submits M bids s_n = {(b^m_n, p^m_n)} with prices ascending.
A truthful bid satisfies p^m = g'_n(b^m) (Definition 1): the demands are
the modified BDF at the price grid.  The operator

  1. builds per-provider pseudo-mBDF step functions (Eq. 22),
  2. aggregates them and finds the pseudo market clearing price
     zeta = sup{ p : d_bar(p) > B }  (Eq. 25),
  3. allocates demand-at-zeta+ plus a proportional split of the surplus
     (Eq. 26),
  4. charges the exclusion-compensation (second-price) term plus the
     ex-post fairness cost (Eq. 27).

Everything is tensor-wise over (N providers, M bids): clearing is one
stable sort and prefix sums over the N*M bid prices.  The leave-one-out
reruns of ``charges(method="rerun")`` and the M+2 columns of
``delta_bound`` are batch dimensions written out.  The prefix sums use
``types.cumsum``, whose float32 add order is fixed, so a book clears the
same on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fairness, intra
from repro_torch.core.types import BISECT_ITERS, ServiceSet, cumsum

_TINY = 1e-30

CHARGE_METHODS = ("prefix", "rerun")


class MultiBid(NamedTuple):
    prices: torch.Tensor   # (N, M) ascending in m
    demands: torch.Tensor  # (N, M) non-increasing in m (mBDF is decreasing)


class AuctionResult(NamedTuple):
    b: torch.Tensor          # (N,) allocated bandwidth
    f: torch.Tensor          # (N,) realized FL frequencies
    price: torch.Tensor      # () pseudo-mMCP zeta
    charges: torch.Tensor    # (N,) total payments (Eq. 27)
    utilities: torch.Tensor  # (N,) f - charges (Eq. 28)


# ---------------------------------------------------------------------------
# Bidding (§V.E uniform multi-bid example).
# ---------------------------------------------------------------------------

def uniform_truthful_bids(svc: ServiceSet, n_bids: int, alpha_fair: float,
                          p_reserve: float = 0.0, p_max_bound=None,
                          iters: int = BISECT_ITERS,
                          backend: str = "reference") -> MultiBid:
    """The operator announces M prices uniformly on (p0, p_max_n) (Eq. 34);
    a truthful provider answers with its mBDF demand at each price.
    ``backend`` selects ``fairness.mbdf_grid``'s implementation:
    ``"reference"`` or ``"pallas"`` (the ``mbdf_demand`` kernel)."""
    pmax = (intra.p_max(svc) if p_max_bound is None
            else torch.as_tensor(p_max_bound, dtype=svc.alpha.dtype,
                                 device=svc.device))
    m = torch.arange(1, n_bids + 1, dtype=svc.alpha.dtype, device=svc.device)
    prices = p_reserve + m[None, :] * (pmax[:, None] - p_reserve) / (n_bids + 1)
    demands = fairness.mbdf_grid(svc, prices, alpha_fair, iters,
                                 backend=backend)
    return MultiBid(prices=prices, demands=demands)


# ---------------------------------------------------------------------------
# Pseudo step functions (Eqns. 22-23).
# ---------------------------------------------------------------------------

def _next_demands(bid: MultiBid) -> torch.Tensor:
    """b^{m+1} per bid, with b^{M+1} = 0 -> (N, M)."""
    return torch.nn.functional.pad(bid.demands[:, 1:], (0, 1))


def _pseudo_mbdf_at(bid: MultiBid, p: torch.Tensor,
                    side: str) -> torch.Tensor:
    """Every provider's pseudo-mBDF at each of the prices p (E,) -> (E, N)."""
    n = bid.prices.shape[0]
    idx = torch.searchsorted(bid.prices.contiguous(),
                             p.reshape(1, -1).expand(n, -1).contiguous(),
                             right=(side == "right"))          # (N, E)
    # demand above the top bid price is 0
    ext = torch.nn.functional.pad(bid.demands, (0, 1))
    return torch.gather(ext, 1, idx).t()


def pseudo_mbdf(bid: MultiBid, p, side: str = "left") -> torch.Tensor:
    """Every provider's pseudo-mBDF at scalar price p -> (N,).

    side='left'  : the (left-continuous) value  d_bar(p)   (Eq. 22)
    side='right' : the limit from above         d_bar(p+)
    """
    p = torch.as_tensor(p, dtype=bid.prices.dtype, device=bid.prices.device)
    return _pseudo_mbdf_at(bid, p.reshape(1), side)[0]


def pseudo_mmvf_integral(bid: MultiBid, lo: torch.Tensor,
                         hi: torch.Tensor) -> torch.Tensor:
    """integral_{lo}^{hi} q_bar_n(b) db per provider -> (..., N).

    q_bar_n (Eq. 23) is p^m on (b^{m+1}, b^m] and 0 above b^1.  ``lo`` and
    ``hi`` are (..., N) with hi >= lo; leading dimensions batch.
    """
    upper = bid.demands                                        # b^m
    lower = _next_demands(bid)                                 # b^{m+1}
    seg = torch.clamp(torch.minimum(hi[..., None], upper)
                      - torch.maximum(lo[..., None], lower), min=0.0)
    return torch.sum(bid.prices * seg, dim=-1)


# ---------------------------------------------------------------------------
# The sorted book and clearing (Eqns. 25-26).
# ---------------------------------------------------------------------------

class _SortedBook(NamedTuple):
    """The joint bid book sorted once by descending price, plus the prefix
    sums every clearing and leave-one-out quantity is read from."""

    delta: torch.Tensor     # (N, M) demand increments b^m - b^{m+1} >= 0
    order: torch.Tensor     # (NM,) sorted position -> flat index
    p_sorted: torch.Tensor  # (NM,) descending prices
    d_sorted: torch.Tensor  # (NM,) delta in sorted order
    csum: torch.Tensor      # (NM,) prefix demand: d_bar at each sorted entry
    vsum: torch.Tensor      # (NM,) prefix of p * delta
    pos_desc: torch.Tensor  # (N, M) each provider's entry ranks, descending price


def _sorted_book(bid: MultiBid) -> _SortedBook:
    n, m = bid.prices.shape
    delta = bid.demands - _next_demands(bid)                   # (N, M) >= 0
    flat_p = bid.prices.reshape(-1)
    # Stable, as jnp.argsort: ties (every inactive row bids at price 0)
    # keep flat order, which feeds pos_desc and the leave-one-out prices.
    order = torch.argsort(-flat_p, stable=True)
    p_sorted = flat_p[order]
    d_sorted = delta.reshape(-1)[order]
    inv = torch.argsort(order, stable=True)                    # flat -> rank
    sums = cumsum(torch.stack([d_sorted, p_sorted * d_sorted]))
    # n's entries in descending-price order = ascending rank; prices ascend
    # in m, so reverse the bid axis.
    return _SortedBook(delta=delta, order=order, p_sorted=p_sorted,
                       d_sorted=d_sorted, csum=sums[0], vsum=sums[1],
                       pos_desc=torch.flip(inv.reshape(n, m), dims=(1,)))


def _clearing_price(book: _SortedBook, total_bandwidth: float,
                    p_reserve: float, weights: torch.Tensor | None
                    ) -> torch.Tensor:
    """zeta for each row of ``weights`` (..., N), or for the whole book."""
    p_sorted = book.p_sorted
    if weights is None:
        csum = book.csum
    else:
        n, m = book.delta.shape
        w_flat = torch.broadcast_to(weights[..., None],
                                    (*weights.shape, m)).reshape(
            *weights.shape[:-1], n * m)
        csum = cumsum(book.d_sorted * w_flat[..., book.order])
    # d_bar(p_i) must include every bid at price == p_i: only the last entry
    # of an equal-price run carries the right prefix sum.
    is_last = torch.cat([p_sorted[:-1] > p_sorted[1:],
                         torch.ones((1,), dtype=torch.bool,
                                    device=p_sorted.device)])
    exceeds = (csum > total_bandwidth) & is_last & (p_sorted > p_reserve)
    # exceeds is monotone along the descending order once true, so the
    # first True has the largest price (argmax returns the first maximum).
    first_idx = torch.argmax(exceeds.to(torch.int32), dim=-1)
    return torch.where(torch.any(exceeds, dim=-1), p_sorted[first_idx],
                       torch.full_like(p_sorted[first_idx], p_reserve))


def clearing_price(bid: MultiBid, total_bandwidth: float,
                   p_reserve: float = 0.0,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """zeta = sup{ p : d_bar(p) > B } via descending-price prefix sums.

    As the price drops past p^m_n, the aggregate demand jumps by
    delta = b^m_n - b^{m+1}_n >= 0; the prefix sum over the book sorted by
    descending price is d_bar at each price.  ``weights`` (N,) in {0, 1}
    excludes providers by reweighting the sorted deltas (the price order
    does not depend on it).
    """
    return _clearing_price(_sorted_book(bid), total_bandwidth, p_reserve,
                           weights)


def _allocate_at_price(bid: MultiBid, zeta: torch.Tensor,
                       total_bandwidth: float,
                       weights: torch.Tensor) -> torch.Tensor:
    """The Eq. 26 allocation rule at a known clearing price.  ``zeta`` ()
    with ``weights`` (N,) -> (N,); or one price per row of ``weights``,
    (E,) with (E, N) -> (E, N)."""
    d_left = _pseudo_mbdf_at(bid, zeta.reshape(-1), "left") * weights
    d_right = _pseudo_mbdf_at(bid, zeta.reshape(-1), "right") * weights
    agg_right = torch.sum(d_right, dim=-1, keepdim=True)
    jump = d_left - d_right
    agg_jump = torch.sum(jump, dim=-1, keepdim=True)
    surplus = torch.clamp(total_bandwidth - agg_right, min=0.0)
    share = torch.where(agg_jump > _TINY,
                        jump / torch.clamp(agg_jump, min=_TINY) * surplus, 0.0)
    return (d_right + share).reshape(weights.shape)


def allocate(bid: MultiBid, total_bandwidth: float, p_reserve: float = 0.0,
             weights: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bandwidth allocation rule (Eq. 26).  Returns (b, zeta).

    b_n = d_bar_n(zeta+) + [d_bar_n(zeta) - d_bar_n(zeta+)] /
          [d_bar(zeta) - d_bar(zeta+)] * (B - d_bar(zeta+))
    """
    w = (torch.ones((bid.prices.shape[0],), dtype=bid.prices.dtype,
                    device=bid.prices.device) if weights is None else weights)
    zeta = clearing_price(bid, total_bandwidth, p_reserve, weights=w)
    return _allocate_at_price(bid, zeta, total_bandwidth, w), zeta


def _prefix_at(prefix: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Prefix-sum value after ``count`` sorted entries (0 for count == 0)."""
    return torch.where(count > 0, prefix[torch.clamp(count - 1, min=0)], 0.0)


def _count_above(book: _SortedBook, zeta: torch.Tensor,
                 strict: bool) -> torch.Tensor:
    """How many sorted entries have price > zeta (strict) or >= zeta."""
    nm = book.p_sorted.shape[0]
    asc = torch.flip(book.p_sorted, dims=(0,))
    return nm - torch.searchsorted(asc, zeta.contiguous(), right=strict)


def leave_one_out_prices(bid: MultiBid, total_bandwidth: float,
                         p_reserve: float = 0.0) -> torch.Tensor:
    """All N leave-one-out clearing prices zeta(s_{-n}) from ONE sorted book.

    The excluded aggregate d_bar_{-n}(p_i) = csum_i - cn_i is
    non-decreasing along the sorted order, and n's own cumulative demand
    cn_i is piecewise constant with steps only at n's M bid positions; so
    within each of n's M+1 segments a ``searchsorted`` against the global
    prefix sums finds the first entry whose excluded demand exceeds B.
    The minimum over segments is the leave-one-out clearing index.
    """
    return _loo_prices(_sorted_book(bid), total_bandwidth, p_reserve)


def _loo_prices(book: _SortedBook, total_bandwidth: float,
                p_reserve: float = 0.0) -> torch.Tensor:
    n, m = book.delta.shape
    nm = n * m
    dev = book.delta.device
    # cn on segment s: own demand above that point; v[:, 0] = 0 above n's
    # top bid.
    own_cum = cumsum(torch.flip(book.delta, dims=(1,)))              # (N, M)
    v = torch.nn.functional.pad(own_cum, (1, 0))                     # (N, M+1)
    izero = torch.zeros((n, 1), dtype=book.pos_desc.dtype, device=dev)
    lo = torch.cat([izero, book.pos_desc], dim=1)                    # (N, M+1)
    hi = torch.cat([book.pos_desc,
                    torch.full((n, 1), nm, dtype=book.pos_desc.dtype,
                               device=dev)], dim=1)
    # First rank with csum > B + cn_s (strict, matching clearing_price).
    first_in_seg = torch.searchsorted(book.csum,
                                      (total_bandwidth + v).contiguous(),
                                      right=True)
    cand = torch.maximum(first_in_seg.to(book.pos_desc.dtype), lo)
    first = torch.amin(torch.where(cand < hi, cand, nm), dim=1)     # (N,)
    p_at = book.p_sorted[torch.clamp(first, max=nm - 1)]
    found = (first < nm) & (p_at > p_reserve)
    return torch.where(found, p_at, torch.full_like(p_at, p_reserve))


# ---------------------------------------------------------------------------
# Charging (Eq. 27) + full auction run.
# ---------------------------------------------------------------------------

def charges(svc: ServiceSet, bid: MultiBid, b_alloc: torch.Tensor,
            total_bandwidth: float, alpha_fair: float,
            p_reserve: float = 0.0, method: str = "prefix") -> torch.Tensor:
    """c_n = sum_{j != n} int_{b_j(s)}^{b_j(s_-n)} q_bar_j
    + alpha*(f_n - log(1+f_n)).

    ``method="prefix"`` computes every exclusion's social cost in closed
    form from one sorted book (``_social_cost_prefix``).  ``"rerun"``
    clears the book once per excluded provider: the N exclusion masks are
    a batch dimension, so it builds (N, N*M) prefix sums and an (N, N)
    integral matrix."""
    n = bid.prices.shape[0]
    if method == "rerun":
        eye = torch.eye(n, dtype=bid.prices.dtype, device=bid.prices.device)
        weights = 1.0 - eye                                   # (N excl, N)
        zetas = _clearing_price(_sorted_book(bid), total_bandwidth,
                                p_reserve, weights)           # (N excl,)
        b_without = _allocate_at_price(bid, zetas, total_bandwidth,
                                       weights)               # (N excl, N)
        lo = torch.minimum(b_alloc[None, :], b_without)
        hi = torch.maximum(b_alloc[None, :], b_without)
        # Others' valuation of the bandwidth they lose to n's presence.
        integrals = pseudo_mmvf_integral(bid, lo, hi)         # (N, N)
        social_cost = torch.sum(integrals * weights, dim=1)
    elif method == "prefix":
        social_cost = _social_cost_prefix(bid, b_alloc, total_bandwidth,
                                          p_reserve)
    else:
        raise ValueError(f"unknown charges method {method!r}; "
                         f"expected one of {CHARGE_METHODS}")
    f_real = intra.freq(svc, b_alloc)
    return social_cost + fairness.fairness_cost(f_real, alpha_fair)


def _social_cost_prefix(bid: MultiBid, b_alloc: torch.Tensor,
                        total_bandwidth: float,
                        p_reserve: float = 0.0) -> torch.Tensor:
    """sum_{j != n} [F_j(b_j(s_{-n})) - F_j(b_j(s))] for every n, where
    F_j(x) = int_0^x q_bar_j, read off prefix sums at the N leave-one-out
    prices (``_loo_prices``): G(zeta) = sum_j F_j(d_j(zeta+)) is the prefix
    of p * delta; non-jumping providers get d_j(zeta_n+) exactly; jumping
    providers split the surplus inside the segment where q_bar_j ==
    zeta_n, which sums to zeta_n * surplus_n."""
    book = _sorted_book(bid)
    zetas = _loo_prices(book, total_bandwidth, p_reserve)        # (N,)
    cnt_gt = _count_above(book, zetas, strict=True)
    cnt_ge = _count_above(book, zetas, strict=False)
    g_at = _prefix_at(book.vsum, cnt_gt)            # sum_j F_j(d_j(zeta+))
    agg_right_all = _prefix_at(book.csum, cnt_gt)   # d_bar(zeta+)
    agg_left_all = _prefix_at(book.csum, cnt_ge)    # d_bar(zeta)

    own_gt = bid.prices > zetas[:, None]                         # (N, M)
    own_eq = bid.prices == zetas[:, None]
    d_right_own = torch.sum(torch.where(own_gt, book.delta, 0.0), dim=1)
    f_own = torch.sum(torch.where(own_gt, bid.prices * book.delta, 0.0),
                      dim=1)
    jump_own = torch.sum(torch.where(own_eq, book.delta, 0.0), dim=1)

    agg_right = agg_right_all - d_right_own    # sum_{j!=n} d_j(zeta_n+)
    agg_jump = agg_left_all - agg_right_all - jump_own
    surplus = torch.clamp(total_bandwidth - agg_right, min=0.0)
    jump_corr = torch.where(agg_jump > _TINY, zetas * surplus, 0.0)

    f_at_alloc = pseudo_mmvf_integral(bid, torch.zeros_like(b_alloc),
                                      b_alloc)                   # (N,)
    others_at_alloc = torch.sum(f_at_alloc) - f_at_alloc

    social = (g_at - f_own + jump_corr) - others_at_alloc
    # >= 0 in exact arithmetic; clamp the float residue.
    return torch.clamp(social, min=0.0)


def run_auction(svc: ServiceSet, total_bandwidth: float, n_bids: int = 5,
                alpha_fair: float = 0.5, p_reserve: float = 0.0,
                backend: str = "reference") -> AuctionResult:
    """End-to-end fairness-adjusted multi-bid auction with truthful bidders.
    ``backend`` is ``uniform_truthful_bids``'s (the JAX entry has none and
    uses ``"reference"``)."""
    bid = uniform_truthful_bids(svc, n_bids, alpha_fair, p_reserve,
                                backend=backend)
    b, zeta = allocate(bid, total_bandwidth, p_reserve)
    c = charges(svc, bid, b, total_bandwidth, alpha_fair, p_reserve)
    f = intra.freq(svc, b)
    return AuctionResult(b=b, f=f, price=zeta, charges=c, utilities=f - c)


# ---------------------------------------------------------------------------
# Incentive diagnostics (Prop. 5, Eq. 31).
# ---------------------------------------------------------------------------

def delta_bound(svc: ServiceSet, bid: MultiBid, alpha_fair: float,
                p_reserve: float = 0.0) -> torch.Tensor:
    """The truthfulness gap Delta_n = max_m int_{d(p^{m+1})}^{d(p^m)}
    (q(b) - p^m) db (Eq. 31) against the true mBDF/mMVF, exact in closed
    form since q = g':  [g(b_hi) - g(b_lo)] - p * (b_hi - b_lo).  The M+2
    price columns are one batch: the set is replicated column-major, so
    every column solves as one block of rows."""
    n, m = bid.prices.shape
    pmax = intra.p_max(svc)
    # p^0 = p_reserve, p^1..p^M from the bids, p^{M+1} = q(0) = p_max.
    prices_ext = torch.cat(
        [torch.full((n, 1), p_reserve, dtype=bid.prices.dtype,
                    device=bid.prices.device), bid.prices, pmax[:, None]],
        dim=1)                                                   # (N, M+2)
    cols = m + 2
    rep = ServiceSet(alpha=svc.alpha.repeat(cols, 1),
                     t_comp=svc.t_comp.repeat(cols, 1),
                     mask=svc.mask.repeat(cols, 1))
    d_ext = fairness.mbdf(rep, prices_ext.t().reshape(-1), alpha_fair)
    f_ext = intra.freq(rep, d_ext)
    d_ext = d_ext.reshape(cols, n).t()                           # (N, M+2)
    g_ext = fairness.g_value(f_ext.reshape(cols, n).t(), alpha_fair)

    b_hi, b_lo = d_ext[:, :-1], d_ext[:, 1:]                     # m = 0..M
    g_hi, g_lo = g_ext[:, :-1], g_ext[:, 1:]
    seg = (g_hi - g_lo) - prices_ext[:, :-1] * (b_hi - b_lo)
    return torch.amax(seg, dim=1)
