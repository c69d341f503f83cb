"""The port's allocation kernels: plain versions against the JAX Pallas
kernels, dispatch by device, and (on a card) CUDA kernels against their
plain versions.

On the CPU every wrapper in ``repro_torch.kernels.ops`` takes the kernel's
plain PyTorch version; these tests hold those against the TPU kernels run in
Pallas interpret mode, on ``tests/test_tile_edges.py``'s shape matrix (N not
a multiple of the TPU row tile, K not a multiple of 128, an all-inactive
row) and ``tests/test_market_clear.py``'s seeds.  Tolerances are the JAX
package's kernel-vs-``ref.py`` ones.

The kernel-vs-plain cases need a CUDA card; they decide at set-up time and
skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disba as j_disba
from repro.core import types as j_types
from repro.kernels.bisect_alloc import bisect_alloc as j_bisect_alloc
from repro.kernels.dual_demand import dual_demand as j_dual_demand
from repro.kernels.market_clear import market_clear as j_market_clear
from repro_torch.kernels import ops
from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
from repro_torch.kernels.dual_demand import dual_demand_plain
from repro_torch.kernels.market_clear import (market_clear_plain,
                                              mbdf_demand_plain)

B = 10.0
EDGE_SHAPES = [(5, 13), (9, 130), (13, 100), (21, 257)]

# The condition is a string, so pytest evaluates it when each test is set
# up, never while the module is imported.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _edge_arrays(seed, n, k, min_clients=1):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.01, 0.3, size=(n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, size=(n, k)).astype(np.float32)
    mask = np.zeros((n, k), dtype=bool)
    for i in range(n):
        mask[i, : rng.integers(min_clients, k + 1)] = True
    mask[rng.integers(0, n)] = False          # a fully-inactive slot
    return (np.where(mask, alpha, 0.0).astype(np.float32),
            np.where(mask, t_comp, 0.0).astype(np.float32), mask)


def _cold_lam(a, t, m):
    svc = j_types.ServiceSet(alpha=jnp.asarray(a), t_comp=jnp.asarray(t),
                             mask=jnp.asarray(m))
    return float(j_disba.solve_lambda_bisect(svc, B).lam)


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", EDGE_SHAPES)
def test_bisect_alloc_plain_matches_pallas(n, k):
    a, t, m = _edge_arrays(1, n, k)
    b = np.random.default_rng(2).uniform(0.2, 4.0, n).astype(np.float32)
    b = np.where(m.any(1), b, 0.0).astype(np.float32)
    jt, jb = j_bisect_alloc(jnp.asarray(a), jnp.asarray(t), jnp.asarray(b),
                            interpret=True)
    tt, tb = ops.intra_allocate(torch.as_tensor(a), torch.as_tensor(t),
                                torch.as_tensor(m), torch.as_tensor(b))
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-4)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,k", EDGE_SHAPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_dual_demand_plain_matches_pallas(n, k, per_row):
    a, t, m = _edge_arrays(0, n, k)
    lam = (np.linspace(0.05, 0.5, n).astype(np.float32) if per_row
           else np.float32(0.2))
    jb, js = j_dual_demand(jnp.asarray(a), jnp.asarray(t), jnp.asarray(lam),
                           interpret=True)
    tb, ts = ops.dual_demand(torch.as_tensor(a), torch.as_tensor(t),
                             torch.as_tensor(m), torch.as_tensor(lam))
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-3, atol=1e-4)
    assert np.all(_np(tb)[~m.any(1)] == 0.0)


@pytest.mark.parametrize("n,k,seed_scale,iters,newton_inner", [
    (9, 31, 1.03, 6, 24),    # warm: the temporal-coherence case
    (9, 31, 0.7, 6, 24),     # stale seed -> safeguarded recovery
    (9, 31, None, 6, 24),    # cold sentinel
    (9, 31, None, 12, 48),   # the cold "megakernel" coop configuration
    (21, 257, 1.03, 6, 24),  # tile edges
    (13, 100, 1.03, 6, 24),
])
def test_market_clear_plain_matches_pallas(n, k, seed_scale, iters,
                                           newton_inner):
    a, t, m = _edge_arrays(2, n, k, min_clients=2)
    lam_prev = np.float32(-1.0 if seed_scale is None
                          else _cold_lam(a, t, m) * seed_scale)
    kw = dict(iters=iters, inner_iters=48, newton_inner_iters=newton_inner)
    jb, jf, jl = j_market_clear(jnp.asarray(a), jnp.asarray(t), jnp.float32(B),
                                jnp.asarray(lam_prev), tile_n=8,
                                interpret=True, **kw)
    tb, tf, tl = ops.market_clear(torch.as_tensor(a), torch.as_tensor(t),
                                  torch.as_tensor(m), B,
                                  torch.tensor(lam_prev), **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(tb.sum()), B, rtol=1e-5)
    inactive = ~m.any(1)
    assert np.all(_np(tb)[inactive] == 0.0) and np.all(_np(tf)[inactive] == 0.0)


def test_market_clear_all_inactive_market():
    a, t, m = _edge_arrays(5, 9, 31)
    zeros = np.zeros_like(a)
    jb, jf, jl = j_market_clear(jnp.asarray(zeros), jnp.asarray(zeros),
                                jnp.float32(B), jnp.float32(0.2), tile_n=8,
                                interpret=True)
    tb, tf, tl = ops.market_clear(torch.as_tensor(zeros), torch.as_tensor(zeros),
                                  torch.zeros(zeros.shape, dtype=torch.bool),
                                  B, torch.tensor(0.2))
    assert np.all(_np(tb) == 0.0) and np.all(_np(tf) == 0.0)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


# ---------------------------------------------------------------------------
# Dispatch: the tensor's device decides; inputs are validated.
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    ops.reset_launches()
    a, t, m = (torch.as_tensor(x) for x in _edge_arrays(3, 7, 19))
    b = torch.full((7,), 1.5)
    got = ops.intra_allocate(a, t, m, b)
    want = bisect_alloc_plain(a, t, m, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lam = torch.tensor(0.25)
    assert all(torch.equal(g, w) for g, w in
               zip(ops.dual_demand(a, t, m, lam),
                   dual_demand_plain(a, t, m, lam)))
    got = ops.market_clear(a, t, m, B, torch.tensor(-1.0))
    want = market_clear_plain(a, t, m, B, torch.tensor(-1.0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


@pytest.mark.parametrize("bad,error", [
    ("float64", TypeError),
    ("transposed", ValueError),
    ("shape", ValueError),
    ("lam_shape", ValueError),
    ("too_many_clients", ValueError),
    ("mask_dtype", TypeError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, error):
    a, t, m = (torch.as_tensor(x) for x in _edge_arrays(4, 6, 6))
    lam = torch.tensor(0.2)
    if bad == "float64":
        a = a.double()
    elif bad == "transposed":
        a = a.t()
    elif bad == "shape":
        t = t[:, :5]
    elif bad == "lam_shape":
        lam = torch.full((5,), 0.2)
    elif bad == "mask_dtype":
        m = m.to(torch.uint8)
    else:
        a = t = torch.zeros((2, ops.MAX_K + 1))
        m = torch.zeros(a.shape, dtype=torch.bool)
    with pytest.raises(error):
        ops.dual_demand(a, t, m, lam)


# ---------------------------------------------------------------------------
# B3 and B4's lane groups and B3's mailbox tags, chosen on the host.
# ---------------------------------------------------------------------------

@needs_cuda
def test_cuda_lane_group_covers_every_k():
    """For every K the kernels take, the lane group the C code picks: L a
    power of two in [8, 32], L R >= K with R <= 32, and no more lanes than
    8 clients a lane need; (8, 4) at K = 32 and (8, 6) at 45."""
    from repro_torch.kernels.market_clear import grid_limits

    for k in range(1, ops.MAX_K + 1):
        lanes, regs = grid_limits(k, 0)[2:]
        assert lanes in (8, 16, 32) and regs <= 32, k
        assert lanes * regs >= k, k
        assert lanes == 8 or lanes * 4 < k <= 8 * lanes or lanes == 32, k
    assert grid_limits(32, 0)[2:] == (8, 4)
    assert grid_limits(45, 0)[2:] == (8, 6)


def test_market_clear_refuses_graph_capture(monkeypatch):
    """The mailbox tags are handed out on the host at each launch, so a
    captured launch would replay stale tags: the launcher raises first."""
    from repro_torch.kernels import market_clear as mc

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    a = t = torch.ones((4, 3))
    with pytest.raises(RuntimeError, match="CUDA graph"):
        mc.market_clear_cuda(a, t, a > 0, B, torch.tensor(0.1))


def test_mailbox_tags_only_grow():
    """Each launch gets tags above every earlier launch's, from one
    zeroed slot buffer per device; on wrap-around the tags are zeroed."""
    from repro_torch.kernels.market_clear import _Mailboxes

    boxes = _Mailboxes()
    cpu = torch.device("cpu")
    part, tags, cap, first = boxes.take(cpu, 132, 8)
    assert (cap, first) == (132, 1) and tags - part == 16 * 132
    buf = boxes.slots[None][0]
    assert buf.numel() * 4 == 24 * 132 and not bool(buf.any())
    assert boxes.take(cpu, 132, 14)[3] == 9
    assert boxes.take(cpu, 100, 8)[3] == 23
    assert boxes.slots[None][0] is buf          # no new buffer
    buf[4 * 132:] = 7
    boxes.next_tag[None] = (1 << 32) - 5
    assert boxes.take(cpu, 132, 8)[3] == 1
    assert not bool(buf[4 * 132:].any())
    assert boxes.take(cpu, 264, 8)[3] == 9
    assert boxes.slots[None][0].numel() == 6 * 264


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (run on a card only).
# ---------------------------------------------------------------------------

def _cuda_market(n=8191, k=45):
    return tuple(torch.as_tensor(x).cuda()
                 for x in _edge_arrays(6, n, k, min_clients=min(2, k)))


# B1 and B2 at the main path's shape (the paper's ten services, K = 45,
# where the launch speculates) and at a market shape (depth 1).
B12_SHAPES = [(10, 45), (8191, 45)]


@needs_cuda
@pytest.mark.parametrize("n,k", B12_SHAPES)
def test_cuda_bisect_alloc_matches_plain(n, k):
    a, t, mk = _cuda_market(n, k)
    b = torch.where(a.sum(1) > 0, 1e-3, 0.0)
    got = ops.intra_allocate(a, t, mk, b)
    want = bisect_alloc_plain(a, t, mk, b)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("n,k", B12_SHAPES)
def test_cuda_dual_demand_matches_plain(n, k):
    a, t, mk = _cuda_market(n, k)
    lam = torch.tensor(0.2, device="cuda")
    for g, w in zip(ops.dual_demand(a, t, mk, lam),
                    dual_demand_plain(a, t, mk, lam)):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("n,k", B12_SHAPES + [(31, 1), (31, 64), (31, 128)])
def test_cuda_speculation_depths_give_the_same_bits(n, k):
    """B1's (t*, split) and B2's (b, slope) at depth 2, where it is
    compiled (K <= 64), are the bits of depth 1, at 24, 48 and 7 trips."""
    from repro_torch.kernels.bisect_alloc import (bisect_alloc_cuda,
                                                  bisect_alloc_plan)
    from repro_torch.kernels.dual_demand import dual_demand_cuda

    a, t, mk = _cuda_market(n, k)
    b = torch.where(a.sum(1) > 0, 1e-3, 0.0)
    lam = torch.full((n,), 0.02, device="cuda")
    depths = [1, 2] if k <= 64 else [1]
    assert [bisect_alloc_plan(n, k, j) for j in depths] == depths
    for iters in (24, 48, 7):
        first = [bisect_alloc_cuda(a, t, mk, b, iters, depth=1),
                 dual_demand_cuda(a, t, mk, lam, iters, depth=1)]
        for j in depths[1:]:
            again = [bisect_alloc_cuda(a, t, mk, b, iters, depth=j),
                     dual_demand_cuda(a, t, mk, lam, iters, depth=j)]
            for x, y in zip(sum(map(list, first), []),
                            sum(map(list, again), [])):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@needs_cuda
def test_cuda_speculation_table_covers_every_k():
    """For every K the kernels take: depth 1 always has a kernel; depth 2
    exactly where lane_group gives groups of 8 lanes (K <= 64), four to a
    warp; a launch picks depth 2 only there and only for a few rows a SM
    (none at the market's 8192 rows)."""
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plan
    from repro_torch.kernels.market_clear import grid_limits

    for k in range(1, ops.MAX_K + 1):
        lanes = grid_limits(k, 0)[2]
        assert bisect_alloc_plan(1, k, 1) == 1, k
        if lanes == 8:
            assert bisect_alloc_plan(1, k, 2) == 2, k
        else:
            assert k > 64, k
            with pytest.raises(ValueError):
                bisect_alloc_plan(1, k, 2)
        assert bisect_alloc_plan(10, k) == (2 if k <= 64 else 1), k
        assert bisect_alloc_plan(8192, k) == 1, k


@needs_cuda
def test_cuda_market_clear_matches_plain():
    a, t, mk = _cuda_market()
    seed = torch.tensor(-1.0, device="cuda")
    kw = dict(iters=12, newton_inner_iters=48)
    got = ops.market_clear(a, t, mk, B, seed, **kw)
    want = market_clear_plain(a, t, mk, B, seed, **kw)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)


@needs_cuda
def test_cuda_mbdf_demand_matches_plain():
    from repro_torch.core import auction
    from repro_torch.core.types import ServiceSet

    a, t, mk = _cuda_market()
    svc = ServiceSet(alpha=a, t_comp=t, mask=mk)
    for alpha_fair in (0.0, 0.5, 1.0):
        prices = auction.uniform_truthful_bids(svc, 5, alpha_fair).prices
        got = ops.mbdf_demand(a, t, mk, prices, alpha_fair)
        want = mbdf_demand_plain(a, t, mk, prices, alpha_fair)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# The shape matrix of tests/test_tile_edges.py for B3 and B4 on the card:
# every lane-group width, the ragged edges of N and K, an all-inactive
# market and one with a single active row (chip_smoke.py's edge_matrix).
CUDA_EDGE = ([(n, k, "ragged") for n in (1, 31, 8191)
              for k in (1, 7, 31, 32, 33, 45, 64, 65, 128, 1024)]
             + [(31, 45, "none"), (31, 45, "one")])


def _cuda_edge_market(n, k, active):
    rng = np.random.default_rng([n, k])
    a = rng.uniform(0.01, 0.3, (n, k)).astype(np.float32)
    t = rng.uniform(0.01, 0.06, (n, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < rng.integers(1, k + 1, (n, 1))
    if active == "ragged":
        mask[5::10] = False
    else:
        mask[:] = False
        if active == "one":
            mask[n // 2, : max(1, k // 2)] = True
    return (torch.as_tensor(np.where(mask, a, 0.0)).cuda(),
            torch.as_tensor(np.where(mask, t, 0.0)).cuda(),
            torch.as_tensor(mask).cuda())


@needs_cuda
@pytest.mark.parametrize("n,k,active", CUDA_EDGE)
def test_cuda_market_clear_edges_match_plain(n, k, active):
    a, t, mk = _cuda_edge_market(n, k, active)
    cold = market_clear_plain(a, t, mk, B,
                              torch.tensor(-1.0, device="cuda"),
                              iters=12, newton_inner_iters=48)[2]
    seed = (cold * 1.03).contiguous()
    got = ops.market_clear(a, t, mk, B, seed)
    want = market_clear_plain(a, t, mk, B, seed)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)
    again = ops.market_clear(a, t, mk, B, seed)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@needs_cuda
@pytest.mark.parametrize("m", [1, 5, 8, 9])
@pytest.mark.parametrize("n,k,active", CUDA_EDGE)
def test_cuda_mbdf_demand_edges_match_plain(n, k, active, m):
    a, t, mk = _cuda_edge_market(n, k, active)
    asum = a.sum(dim=1)
    pmax = torch.where(asum > 0, 1.0 / torch.clamp(asum, min=1e-30), 0.0)
    steps = torch.arange(1, m + 1, dtype=torch.float32, device="cuda")
    prices = (1.15 * steps[None, :] * pmax[:, None] / (m + 1)).contiguous()
    got = ops.mbdf_demand(a, t, mk, prices, 0.5)
    want = mbdf_demand_plain(a, t, mk, prices, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert bool((got >= 0).all()) and bool((got[:, 1:] <= got[:, :-1]).all())
    assert bool((got[asum == 0] == 0).all())


# ---------------------------------------------------------------------------
# Attention kernels (B5 flash_attention, B6 decode_attention): plain versions
# against the Pallas kernels in interpret mode and against ``ref.py``, on
# ``tests/test_kernels.py``'s shape matrix with its tolerances (float32
# rtol = atol = 2e-5, bfloat16 2e-2).  Inputs are drawn with numpy and cast
# to bfloat16 the same way (round to nearest even) in both packages.  Ragged
# lengths, which the Pallas kernels refuse (their block-divisibility
# asserts), are held against ``ref.py`` only.
# ---------------------------------------------------------------------------

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode_attention  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_attention  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    _COUNTERS, BLOCKS_PER_SM, MAX_SPLITS, MIN_KEYS_PER_SPLIT, _counters,
    decode_attention_plain, split_bounds, split_plan)
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402

ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _heads(seed, dtype, *shapes):
    """numpy normals of each shape, as (jax array, torch tensor) pairs of
    ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, getattr(jnp, dtype)),
                    torch.as_tensor(x).to(getattr(torch, dtype))))
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 4, 2, 256, 64),
    (1, 8, 1, 512, 128),   # MQA
    (2, 2, 2, 128, 256),   # MHA, gemma head_dim
    (1, 4, 4, 384, 64),    # 3 blocks of 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_causal(b, hq, hkv, s, d, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _heads(10, dtype, (b, hq, s, d),
                                          (b, hkv, s, d), (b, hkv, s, d))
    got = ops.attention(tq, tk, tv, causal=True)
    _close(got, j_flash_attention(jq, jk, jv, causal=True, interpret=True),
           dtype)
    _close(got, j_ref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("window", [32, 128, 1024])
def test_flash_attention_plain_matches_pallas_window(window):
    (jq, tq), (jk, tk), (jv, tv) = _heads(11, "float32", (1, 4, 512, 64),
                                          (1, 1, 512, 64), (1, 1, 512, 64))
    got = ops.attention(tq, tk, tv, causal=True, window=window)
    kw = dict(causal=True, window=window)
    _close(got, j_flash_attention(jq, jk, jv, interpret=True, **kw), "float32")
    _close(got, j_ref.flash_attention_ref(jq, jk, jv, **kw), "float32")


def test_flash_attention_plain_matches_pallas_non_causal():
    (jq, tq), (jk, tk), (jv, tv) = _heads(12, "float32", (2, 2, 256, 64),
                                          (2, 2, 256, 64), (2, 2, 256, 64))
    got = ops.attention(tq, tk, tv, causal=False)
    _close(got, j_flash_attention(jq, jk, jv, causal=False, interpret=True),
           "float32")
    _close(got, j_ref.flash_attention_ref(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("b,hq,hkv,s,d,window,causal", [
    (1, 4, 2, 100, 64, 0, True),
    (2, 8, 2, 300, 128, 0, True),     # the chip's ragged shape, shorter
    (1, 4, 1, 77, 32, 16, True),      # reduced gemma3-1b, window binds
    (1, 4, 1, 1100, 256, 1024, True),
    (2, 2, 2, 130, 64, 40, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_ragged_matches_ref(b, hq, hkv, s, d, window,
                                                  causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _heads(13, dtype, (b, hq, s, d),
                                          (b, hkv, s, d), (b, hkv, s, d))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    _close(got, j_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window), dtype)


def test_flash_attention_takes_strided_views():
    """The model hands in (B, S, H, D) tensors transposed to (B, H, S, D);
    the result equals the one from contiguous copies."""
    (_, tq), (_, tk), (_, tv) = _heads(14, "float32", (2, 40, 4, 32),
                                       (2, 40, 2, 32), (2, 40, 2, 32))
    views = [x.transpose(1, 2) for x in (tq, tk, tv)]
    got = ops.attention(*views, causal=True, window=8)
    want = ops.attention(*(x.contiguous() for x in views), causal=True,
                         window=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,hq,hkv,s,d,valid", [
    (2, 8, 2, 512, 64, 512),
    (2, 8, 2, 512, 64, 317),   # partial cache
    (1, 4, 1, 2048, 128, 1500),
    (4, 4, 4, 256, 256, 100),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(b, hq, hkv, s, d, valid, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _heads(15, dtype, (b, hq, d),
                                          (b, s, hkv, d), (b, s, hkv, d))
    got = ops.attention_decode(tq, tk, tv, valid)
    _close(got, j_decode_attention(jq, jk, jv, jnp.int32(valid), block_k=256,
                                   interpret=True), dtype)
    _close(got, j_ref.decode_attention_ref(jq, jk, jv, jnp.int32(valid)),
           dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,valid", [
    (2, 8, 2, 300, 64, 299),
    (4, 4, 1, 2080, 256, 2079),   # gemma3-1b's decode shape
    (1, 8, 1, 77, 32, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_ragged_matches_ref(b, hq, hkv, s, d, valid,
                                                   dtype):
    (jq, tq), (jk, tk), (jv, tv) = _heads(16, dtype, (b, hq, d),
                                          (b, s, hkv, d), (b, s, hkv, d))
    got = ops.attention_decode(tq, tk, tv, valid)
    _close(got, j_ref.decode_attention_ref(jq, jk, jv, jnp.int32(valid)),
           dtype)


def test_decode_attention_window_slice_is_the_windowed_mask():
    """A local layer hands the kernel the cache's last ``window`` filled
    positions: the same as JAX's mask q_pos - kv_pos < window at q_pos =
    valid_len - 1 over the whole cache."""
    from repro.models import layers as j_layers

    s, valid, window = 64, 50, 16
    (jq, tq), (jk, tk), (jv, tv) = _heads(17, "float32", (2, 4, 32),
                                          (2, s, 1, 32), (2, s, 1, 32))
    lo = valid - window
    got = ops.attention_decode(tq, tk[:, lo:valid], tv[:, lo:valid], window)
    mask = j_layers.make_attention_mask(1, s, valid - 1, True, window,
                                        kv_valid_len=valid)
    want = j_layers.attention(jq[:, None], jk, jv, mask)[:, 0]
    _close(got, want, "float32")


def test_cpu_attention_takes_the_plain_path_and_launches_nothing():
    ops.reset_launches()
    (_, tq), (_, tk), (_, tv) = _heads(18, "bfloat16", (1, 4, 33, 64),
                                       (1, 2, 33, 64), (1, 2, 33, 64))
    assert torch.equal(ops.attention(tq, tk, tv, window=8),
                       flash_attention_plain(tq, tk, tv, window=8))
    q1, kc, vc = tq[:, :, 0], tk.transpose(1, 2), tv.transpose(1, 2)
    got = ops.attention_decode(q1, kc, vc, 20)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, decode_attention_plain(q1, kc, vc, 20))
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


@pytest.mark.parametrize("bad,error", [
    ("float64", TypeError),
    ("mixed_dtype", TypeError),
    ("head_dim", ValueError),
    ("groups", ValueError),
    ("lengths", ValueError),
    ("strided_head_dim", ValueError),
    ("window", ValueError),
])
def test_attention_rejects_what_the_kernel_does_not_take(bad, error):
    (_, q), (_, k), (_, v) = _heads(19, "float32", (1, 4, 16, 32),
                                    (1, 2, 16, 32), (1, 2, 16, 32))
    window = 0
    if bad == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "groups":
        k, v = k[:, :1].expand(1, 3, 16, 32), v[:, :1].expand(1, 3, 16, 32)
    elif bad == "lengths":
        k, v = k[:, :, :15], v[:, :, :15]
    elif bad == "strided_head_dim":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        window = -1
    with pytest.raises(error):
        ops.attention(q, k, v, window=window)


@pytest.mark.parametrize("bad,error", [
    ("valid_zero", ValueError),
    ("valid_past_cache", ValueError),
    ("valid_tensor", ValueError),
    ("groups", ValueError),
    ("bf16_mixed", TypeError),
    ("shape", ValueError),
])
def test_attention_decode_rejects_what_the_kernel_does_not_take(bad, error):
    (_, q), (_, k), (_, v) = _heads(20, "float32", (2, 4, 32),
                                    (2, 16, 2, 32), (2, 16, 2, 32))
    valid = 5
    if bad == "valid_zero":
        valid = 0
    elif bad == "valid_past_cache":
        valid = 17
    elif bad == "valid_tensor":
        valid = torch.tensor(5, dtype=torch.int32)
    elif bad == "groups":            # 16 query heads per KV head
        q = torch.zeros((2, 32, 32))
    elif bad == "bf16_mixed":
        q = q.to(torch.bfloat16)
    else:
        v = v[:, :, :1]
    with pytest.raises(error):
        ops.attention_decode(q, k, v, valid)


def test_tensor_core_path_requires_16_byte_rows():
    """The attention kernels read rows 16 bytes at a time; the check runs
    before a CUDA launch and is exercised here on CPU tensors."""
    x = torch.zeros((1, 2, 8, 40), dtype=torch.bfloat16)
    ops._check_rows_aligned("attention", {"q": x[..., :32]})  # rows of 80 B
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_rows_aligned("attention", {"q": x[..., 1:33]})
    y = torch.zeros((1, 2, 8, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_rows_aligned("attention", {"k": y})
    ops._check_rows_aligned("attention",
                            {"v": torch.zeros((1, 8, 2, 32)).transpose(1, 2)})


def test_row_alignment_counts_bytes_in_float32():
    """B6 takes float32 too: its rows need 16 bytes, i.e. strides in
    multiples of 4 float32 elements (8 bf16)."""
    x = torch.zeros((2, 6, 36))
    ops._check_rows_aligned("attention_decode", {"q": x[..., :32]})
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_rows_aligned("attention_decode",
                                {"q": torch.zeros((2, 6, 34))[..., :32]})


def test_tma_strides_reject_broadcast_views():
    """B5's bf16 path loads k and v through TMA tensor maps, which cannot
    step a dim of extent > 1 by stride 0; a dim of extent 1 may have any
    stride."""
    k = torch.zeros((2, 1, 64, 32), dtype=torch.bfloat16)
    ops._check_tma_strides("attention", {"k": k})
    ops._check_tma_strides("attention",
                           {"k": torch.zeros((1, 64, 2, 32))[:, :, :1]
                            .transpose(1, 2)})
    with pytest.raises(ValueError, match="stride-0"):
        ops._check_tma_strides("attention", {"v": k.expand(2, 3, 64, 32)})


def test_attention_decode_checks_alignment_before_a_launch(monkeypatch):
    """On the CUDA path, ops.attention_decode validates row alignment before
    it reaches the kernel (exercised on CPU tensors routed as CUDA)."""
    (_, q), (_, k), (_, v) = _heads(23, "float32", (2, 4, 32),
                                    (2, 16, 2, 34), (2, 16, 2, 34))
    monkeypatch.setattr(ops, "_check_heads", lambda *args: True)
    monkeypatch.setattr(ops, "decode_attention_cuda",
                        lambda *args: pytest.fail("launched"))
    with pytest.raises(ValueError, match="16-byte"):
        ops.attention_decode(q, k[..., :32], v[..., :32], 9)


@pytest.mark.parametrize("bh,valid_len", [
    (4, 2079), (4, 1024), (4, 1337), (4, 1), (4, 15), (4, 16), (4, 17),
    (1, 5000), (8, 2079), (64, 299), (512, 32000), (2, 4999)])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_decode_split_plan_covers_every_key_once(bh, valid_len, n_sms):
    n = split_plan(bh, valid_len, n_sms)
    assert 1 <= n <= min(valid_len, MAX_SPLITS)
    bounds = split_bounds(valid_len, n)
    keys = [key for lo, hi in bounds for key in range(lo, hi)]
    assert keys == list(range(valid_len))            # each key exactly once
    assert min(hi - lo for lo, hi in bounds) >= min(valid_len,
                                                    MIN_KEYS_PER_SPLIT)
    # enough blocks for 2 per SM unless the 16-key floor or the cap binds
    assert (n * bh >= BLOCKS_PER_SM * n_sms
            or n == valid_len // MIN_KEYS_PER_SPLIT or n == MAX_SPLITS
            or n == 1)


def test_decode_split_plan_at_the_decode_shape():
    """gemma3-1b's decode (B = 4, Hkv = 1, 2079 keys) on an H100's 132 SMs:
    66 splits of 31-32 keys, 2 blocks per SM."""
    n = split_plan(4, 2079, 132)
    assert n == 66 and 4 * n >= 2 * 132
    assert {hi - lo for lo, hi in split_bounds(2079, n)} == {31, 32}


def test_decode_counters_are_zeroed_once_and_grown():
    device = torch.device("cpu")
    _COUNTERS.pop(device, None)
    first = _counters(device, 8)
    assert first.dtype == torch.int32 and first.numel() >= 8
    assert not first.any()
    assert _counters(device, 8) is first              # cached
    grown = _counters(device, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert _counters(device, 8) is grown
    _COUNTERS.pop(device, None)


def _cuda_heads(seed, dtype, *shapes):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in shapes]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (4, 4, 1, 2048, 256, 1024), (4, 4, 1, 2048, 256, 0),
    (2, 8, 2, 1100, 128, 0), (1, 4, 1, 77, 32, 16),
    (2, 4, 1, 77, 32, 0),          # D = 32 (64-byte swizzle), ragged S
    (1, 2, 2, 1100, 64, 0),        # D = 64, G = 1
    (1, 4, 2, 200, 128, 0),        # G = 2
    (1, 8, 1, 300, 64, 0),         # G = 8
    (1, 6, 2, 100, 64, 0),         # G = 3: a tile's heads are no TMA box
    (1, 4, 1, 500, 256, 10),       # a window shorter than a tile
    (1, 4, 1, 40, 256, 0)])        # S shorter than a tile
def test_cuda_flash_attention_matches_plain(dtype, b, hq, hkv, s, d, window):
    q, k, v = _cuda_heads(0, dtype, (b, hq, s, d), (b, hkv, s, d),
                          (b, hkv, s, d))
    tol = ATTN_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    torch.testing.assert_close(
        ops.attention(q, k, v, window=window),
        flash_attention_plain(q, k, v, window=window), **tol)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (4, 4, 1, 2048, 256, 1024), (2, 8, 2, 1100, 128, 0),
    (1, 4, 1, 77, 32, 0)])
def test_cuda_flash_attention_takes_serve_layout_views(dtype, b, hq, hkv, s,
                                                       d, window):
    """Transposed views of (B, S, H, D) tensors, as the model hands them
    in: the tensor maps order the dims by stride; no copy."""
    q, k, v = _cuda_heads(4, dtype, (b, s, hq, d), (b, s, hkv, d),
                          (b, s, hkv, d))
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    tol = ATTN_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    got = ops.attention(q, k, v, window=window)
    assert got.stride() == q.stride()
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, window=window), **tol)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,valid,lo", [
    (4, 4, 1, 2080, 256, 2079, 0), (4, 4, 1, 2080, 256, 2079, 1055),
    (2, 8, 2, 512, 64, 317, 0), (1, 8, 1, 77, 32, 1, 0),
    (4, 4, 1, 2080, 256, 1337, 0),  # 66 splits that do not divide 1337
    (2, 2, 2, 40, 128, 1, 0),       # valid_len 1
    (64, 8, 8, 300, 128, 299, 0)])  # one split per (batch, KV head)
def test_cuda_decode_attention_matches_plain(dtype, b, hq, hkv, s, d, valid,
                                             lo):
    q, k, v = _cuda_heads(1, dtype, (b, hq, d), (b, s, hkv, d),
                          (b, s, hkv, d))
    tol = ATTN_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    torch.testing.assert_close(
        ops.attention_decode(q, k[:, lo:valid], v[:, lo:valid], valid - lo),
        decode_attention_plain(q, k[:, lo:valid], v[:, lo:valid], valid - lo),
        **tol)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_resets_its_tickets(dtype):
    """Two calls of different shapes, back to back and then again, give
    equal results: each launch leaves its ticket counters at 0."""
    big = _cuda_heads(2, dtype, (4, 4, 256), (4, 2080, 1, 256),
                      (4, 2080, 1, 256))
    small = _cuda_heads(3, dtype, (2, 8, 64), (2, 100, 2, 64),
                        (2, 100, 2, 64))
    first = [ops.attention_decode(*big, 2079),
             ops.attention_decode(*small, 37)]
    second = [ops.attention_decode(*big, 2079),
              ops.attention_decode(*small, 37)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert not _counters(big[0].device, 1).any()


# ---------------------------------------------------------------------------
# The mLSTM kernel (B7 mlstm_chunk): the plain version against the Pallas
# kernel in interpret mode and ``ref.mlstm_chunk_ref`` (the parallel form)
# on ``tests/test_kernels.py``'s shapes with its inputs' recipe (k / sqrt(Dh),
# i ~ N(0, 0.5), f ~ N(2, 0.5)) and tolerances (float32 rtol = atol = 5e-4,
# bfloat16 5e-2).  The state the TPU kernel drops, a given initial state and
# ragged lengths are held against ``ssm.mlstm_chunkwise``.
# ---------------------------------------------------------------------------

from repro.kernels.mlstm_chunk import mlstm_chunk as j_mlstm_chunk  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.kernels.mlstm_chunk import (  # noqa: E402
    CHUNK, chunk_outputs_plain, chunk_states_plain, mlstm_chunk_plain)

MLSTM_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _mlstm_pairs(seed, dtype, b, h, s, dh, state=False):
    """(jax, torch) pairs of q, k, v, i, f in ``dtype`` after the JAX test's
    recipe, and of a float32 state (C, n, m) when ``state``."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((b, h, s, dh)).astype(np.float32)
         for _ in range(3)]
    x[1] = x[1] / np.float32(np.sqrt(dh))
    x.append((rng.standard_normal((b, h, s)) * 0.5).astype(np.float32))
    x.append((rng.standard_normal((b, h, s)) * 0.5 + 2.0).astype(np.float32))
    pairs = [(jnp.asarray(a, getattr(jnp, dtype)),
              torch.as_tensor(a).to(getattr(torch, dtype))) for a in x]
    if state:
        st = [(rng.standard_normal((b, h, dh, dh)) * 0.3).astype(np.float32),
              (rng.standard_normal((b, h, dh)) * 0.3).astype(np.float32),
              (rng.standard_normal((b, h)) * 0.5).astype(np.float32)]
        pairs.append((tuple(jnp.asarray(a) for a in st),
                      tuple(torch.as_tensor(a) for a in st)))
    return pairs


def _mlstm_close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **MLSTM_TOL[dtype])


@pytest.mark.parametrize("b,h,s,dh,chunk", [
    (2, 2, 256, 64, 128),
    (1, 4, 512, 128, 128),
    (2, 1, 256, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_plain_matches_pallas(b, h, s, dh, chunk, dtype):
    pairs = _mlstm_pairs(21, dtype, b, h, s, dh)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    y, (c, n, m) = ops.mlstm(*tx)
    assert y.dtype == tx[0].dtype and y.shape == (b, h, s, dh)
    assert c.shape == (b, h, dh, dh) and c.dtype == torch.float32
    _mlstm_close(y, j_mlstm_chunk(*jx, chunk=chunk, interpret=True), dtype)
    _mlstm_close(y, j_ref.mlstm_chunk_ref(*jx), dtype)
    _, (jc, jn, jm) = j_ssm.mlstm_chunkwise(*jx, chunk=chunk)
    for got, want in ((c, jc), (n, jn), (m, jm)):
        _mlstm_close(got, want, dtype)


@pytest.mark.parametrize("s", [1, 37, 100, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_plain_ragged_matches_ref(s, dtype):
    """Lengths no chunk of 256 divides: one chunk of S, against the parallel
    form and JAX's chunkwise form at chunk S."""
    pairs = _mlstm_pairs(22, dtype, 2, 2, s, 64)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    y, (c, n, m) = ops.mlstm(*tx)
    _mlstm_close(y, j_ref.mlstm_chunk_ref(*jx), dtype)
    jy, (jc, jn, jm) = j_ssm.mlstm_chunkwise(*jx, chunk=s)
    _mlstm_close(y, jy, dtype)
    for got, want in ((c, jc), (n, jn), (m, jm)):
        _mlstm_close(got, want, dtype)


@pytest.mark.parametrize("s", [512, 300])
def test_mlstm_chunk_plain_carries_a_given_state(s):
    """From a non-zero state: y and the final (C, n, m) equal JAX's
    chunkwise form's; and two halves with the state handed across equal the
    whole sequence."""
    pairs = _mlstm_pairs(23, "float32", 2, 2, s, 64, state=True)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    y, state = ops.mlstm(*tx)
    jy, jstate = j_ssm.mlstm_chunkwise(*jx, chunk=256 if s % 256 == 0 else s)
    _mlstm_close(y, jy, "float32")
    for got, want in zip(state, jstate):
        _mlstm_close(got, want, "float32")
    half = s // 2
    first = [x[:, :, :half] for x in tx[:5]]
    second = [x[:, :, half:] for x in tx[:5]]
    y1, mid = ops.mlstm(*first, tx[5])
    y2, end = ops.mlstm(*second, mid)
    _mlstm_close(torch.cat([y1, y2], dim=2), jy, "float32")
    for got, want in zip(end, jstate):
        _mlstm_close(got, want, "float32")


def test_mlstm_takes_strided_views_and_launches_nothing_on_cpu():
    """The model hands in transposed views of its (B, S, H, 3Dh) projection
    and (B, S, 2H) gates; the result equals the one from contiguous
    copies, and the CPU path launches no kernel."""
    ops.reset_launches()
    rng = np.random.default_rng(24)
    qkv = torch.as_tensor(rng.standard_normal((2, 40, 4, 192)).astype(np.float32))
    gates = torch.as_tensor(rng.standard_normal((2, 40, 8)).astype(np.float32))
    q, k, v = (x.transpose(1, 2) for x in torch.split(qkv, 64, dim=-1))
    i_gate, f_gate = gates[..., :4].transpose(1, 2), gates[..., 4:].transpose(1, 2)
    y, state = ops.mlstm(q, k, v, i_gate, f_gate)
    y2, state2 = mlstm_chunk_plain(*(x.contiguous() for x in
                                     (q, k, v, i_gate, f_gate)))
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(state, state2))
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


@pytest.mark.parametrize("bad,error", [
    ("float64", TypeError),
    ("mixed_dtype", TypeError),
    ("head_dim", ValueError),
    ("too_wide", ValueError),
    ("gate_shape", ValueError),
    ("strided_head_dim", ValueError),
    ("state_dtype", ValueError),
    ("state_shape", ValueError),
])
def test_mlstm_rejects_what_the_kernel_does_not_take(bad, error):
    pairs = _mlstm_pairs(25, "float32", 1, 2, 16, 64, state=True)
    q, k, v, ig, fg, state = [p[1] for p in pairs]
    if bad == "float64":
        q, k, v, ig, fg = (x.double() for x in (q, k, v, ig, fg))
    elif bad == "mixed_dtype":
        fg = fg.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
        state = None
    elif bad == "too_wide":
        q = k = v = torch.zeros((1, 2, 16, 1056))
        state = None
    elif bad == "gate_shape":
        ig = ig[:, :, :15]
    elif bad == "strided_head_dim":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "state_dtype":
        state = (state[0].double(), *state[1:])
    else:
        state = (state[0], state[1][..., :32], state[2])
    with pytest.raises(error):
        ops.mlstm(q, k, v, ig, fg, state)


# B7's bf16 path is two kernels, each with a plain version: the states at
# every chunk's start, then y from them.  Composed they are the chunkwise
# form over chunks of CHUNK (the last ragged), held here to JAX's.

def _jax_chunkwise(jx, state=None):
    s = jx[0].shape[2]
    return j_ssm.mlstm_chunkwise(*jx[:5], state,
                                 chunk=CHUNK if s % CHUNK == 0 else s)


@pytest.mark.parametrize("s,with_state", [
    (512, False), (512, True), (300, False), (77, True), (1, False)])
def test_chunk_states_then_outputs_match_jax_chunkwise(s, with_state):
    """At the kernels' chunk length, at ragged lengths and from a given
    state: y and the final (C, n, m) equal JAX's ssm.mlstm_chunkwise, and
    the composition equals mlstm_chunk_plain."""
    pairs = _mlstm_pairs(26, "float32", 2, 2, s, 64, state=with_state)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    state = tx[5] if with_state else None
    states, final = chunk_states_plain(*tx[:5], state)
    n_chunks = -(-s // CHUNK)
    assert [x.shape for x in states] == [(2, 2, n_chunks, 64, 64),
                                         (2, 2, n_chunks, 64), (2, 2, n_chunks)]
    y = chunk_outputs_plain(*tx[:5], states)
    jy, jstate = _jax_chunkwise(jx, jx[5] if with_state else None)
    _mlstm_close(y, jy, "float32")
    for got, want in zip(final, jstate):
        _mlstm_close(got, want, "float32")
    py, pstate = mlstm_chunk_plain(*tx[:5], state)
    _mlstm_close(y, py.numpy(), "float32")
    for got, want in zip(final, pstate):
        _mlstm_close(got, want.numpy(), "float32")


@pytest.mark.parametrize("s,with_state", [(768, False), (700, True)])
def test_chunk_states_equal_jax_on_each_prefix(s, with_state):
    """The state at chunk c's start is JAX's final state over the first
    c CHUNK positions (the given state at c = 0)."""
    pairs = _mlstm_pairs(27, "float32", 1, 2, s, 64, state=with_state)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    states, _ = chunk_states_plain(*tx[:5], tx[5] if with_state else None)
    j_state = jx[5] if with_state else None
    for c in range(-(-s // CHUNK)):
        if c == 0:
            if not with_state:
                assert not states[0][:, :, 0].any() and not states[1][:, :, 0].any()
                assert bool((states[2][:, :, 0] == -1e30).all())
                continue
            want = j_state
        else:
            prefix = [x[:, :, :c * CHUNK] for x in jx[:5]]
            _, want = j_ssm.mlstm_chunkwise(*prefix, j_state, chunk=CHUNK)
        for got, w in zip(states, want):
            _mlstm_close(got[:, :, c], w, "float32")


@needs_cuda
@pytest.mark.parametrize("b,h,s,dh,with_state", [
    (4, 4, 2048, 1024, False), (2, 2, 1100, 128, True), (1, 4, 77, 64, True),
    (1, 2, 600, 192, True), (2, 1, 1, 64, False)])
def test_cuda_mlstm_states_and_outputs_match_their_plain_versions(
        b, h, s, dh, with_state):
    """bf16: the states kernel's chunk states and final state against
    chunk_states_plain; the outputs kernel's y, on those states, against
    chunk_outputs_plain."""
    from repro_torch.kernels.mlstm_chunk import (mlstm_outputs_cuda,
                                                 mlstm_states_cuda)

    gen = torch.Generator(device="cuda").manual_seed(3)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    q, k, v = (draw(b, h, s, dh).to(torch.bfloat16) for _ in range(3))
    k = k / dh ** 0.5
    ig = draw(b, h, s, scale=0.5).to(torch.bfloat16)
    fg = draw(b, h, s, scale=0.5, shift=2.0).to(torch.bfloat16)
    state = None
    if with_state:
        state = (draw(b, h, dh, dh, scale=0.3), draw(b, h, dh, scale=0.3),
                 draw(b, h, scale=0.5))
    tol = MLSTM_TOL["bfloat16"]
    states, final = mlstm_states_cuda(k, v, ig, fg, state)
    want_states, want_final = chunk_states_plain(q, k, v, ig, fg, state)
    for got, want in zip((*states, *final), (*want_states, *want_final)):
        torch.testing.assert_close(got.float(), want, **tol)
    y = mlstm_outputs_cuda(q, k, v, ig, fg, states)
    torch.testing.assert_close(y, chunk_outputs_plain(q, k, v, ig, fg, states),
                               **tol)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,dh,with_state", [
    (4, 4, 2048, 1024, False), (2, 2, 1100, 128, True), (1, 4, 77, 64, True),
    (2, 1, 1, 64, False)])
def test_cuda_mlstm_chunk_matches_plain(dtype, b, h, s, dh, with_state):
    gen = torch.Generator(device="cuda").manual_seed(2)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    q, k, v = (draw(b, h, s, dh).to(dtype) for _ in range(3))
    k = k / dh ** 0.5
    ig, fg = draw(b, h, s, scale=0.5).to(dtype), draw(b, h, s, scale=0.5,
                                                      shift=2.0).to(dtype)
    state = None
    if with_state:
        state = (draw(b, h, dh, dh, scale=0.3), draw(b, h, dh, scale=0.3),
                 draw(b, h, scale=0.5))
    tol = MLSTM_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    y, got = ops.mlstm(q, k, v, ig, fg, state)
    want_y, want = mlstm_chunk_plain(q, k, v, ig, fg, state)
    torch.testing.assert_close(y, want_y, **tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol)
