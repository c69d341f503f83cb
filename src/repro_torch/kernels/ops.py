"""Dispatch wrappers for the allocation, attention and mLSTM kernels.

The device of the tensors decides the path: a CUDA tensor launches the
hand-written kernel (and raises if it cannot), a CPU tensor takes the plain
PyTorch version beside the kernel.  There is no fallback from one to the
other and no switch to force either.  Every wrapper checks device, dtype
(float32 for the allocation kernels, float32 or bfloat16 for attention
and the mLSTM), shape and layout first, and counts its kernel launches in
``LAUNCHES`` (a plain integer per kernel, bumped only where the kernel is
launched), so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bisect_alloc import bisect_alloc_cuda, bisect_alloc_plain
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.dual_demand import dual_demand_cuda, dual_demand_plain
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.market_clear import (market_clear_cuda,
                                              market_clear_plain,
                                              mbdf_demand_cuda,
                                              mbdf_demand_plain)
from repro_torch.kernels.mlstm_chunk import mlstm_chunk_cuda, mlstm_chunk_plain

KERNEL_NAMES = ("bisect_alloc", "dual_demand", "market_clear", "mbdf_demand",
                "flash_attention", "decode_attention", "mlstm_chunk")
MAX_K = 1024  # clients per service the kernels hold in registers (32 x 32)
HEAD_DIMS = (32, 64, 128, 256)     # head dims the attention kernels compile
DECODE_GROUPS = (1, 2, 4, 8)       # query heads per KV head of decode
ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
MLSTM_HEAD_DIM_STEP = 64    # mLSTM head dims: multiples of the kernel's
MLSTM_MAX_HEAD_DIM = 1024   # head-dim tile, up to what its C slice fits

# Launches per kernel; "mlstm_chunk" counts calls, each of which launches
# the states and the outputs kernel in bfloat16 (one kernel in float32).
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, alpha: torch.Tensor, t_comp: torch.Tensor,
             grid: torch.Tensor | None = None,
             **vectors: torch.Tensor) -> bool:
    """Validate a kernel's inputs; True for the CUDA path, False for CPU.
    ``vectors`` are scalars or (N,); ``grid`` an (N, M) matrix."""
    if alpha.ndim != 2 or t_comp.shape != alpha.shape:
        raise ValueError(f"{name}: alpha and t_comp must share one (N, K) "
                         f"shape, got {tuple(alpha.shape)} and "
                         f"{tuple(t_comp.shape)}")
    n, k = alpha.shape
    if n < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: need N >= 1 and 1 <= K <= {MAX_K}, got "
                         f"(N, K) = ({n}, {k})")
    if grid is not None and (grid.ndim != 2 or grid.shape[0] != n
                             or grid.shape[1] < 1):
        raise ValueError(f"{name}: prices must be ({n}, M) with M >= 1, "
                         f"got {tuple(grid.shape)}")
    tensors = {"alpha": alpha, "t_comp": t_comp, **vectors}
    if grid is not None:
        tensors["prices"] = grid
    for key, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {x.dtype}")
        if x.device != alpha.device:
            raise ValueError(f"{name}: {key} is on {x.device}, alpha on "
                             f"{alpha.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, x in vectors.items():
        if x.ndim > 1 or (x.ndim == 1 and x.shape[0] != n):
            raise ValueError(f"{name}: {key} must be a scalar or ({n},), "
                             f"got {tuple(x.shape)}")
    if alpha.device.type == "cuda":
        return True
    if alpha.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {alpha.device}")


def intra_allocate(alpha: torch.Tensor, t_comp: torch.Tensor, b: torch.Tensor,
                   *, iters: int = 48) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7 per service -> (t* (N,), per-client split (N, K))."""
    if b.ndim != 1:
        raise ValueError(f"intra_allocate: b must be (N,), got {tuple(b.shape)}")
    if _on_cuda("intra_allocate", alpha, t_comp, b=b):
        out = bisect_alloc_cuda(alpha, t_comp, b, iters)
        LAUNCHES["bisect_alloc"] += 1
        return out
    return bisect_alloc_plain(alpha, t_comp, b, iters)


def dual_demand(alpha: torch.Tensor, t_comp: torch.Tensor, lam: torch.Tensor,
                *, iters: int = 48) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-service demand b_n(lam) and slope db_n/dlam -> ((N,), (N,)).
    ``lam`` is a 0-d or (N,) float32 tensor on the tensors' device."""
    if _on_cuda("dual_demand", alpha, t_comp, lam=lam):
        out = dual_demand_cuda(alpha, t_comp, lam, iters)
        LAUNCHES["dual_demand"] += 1
        return out
    return dual_demand_plain(alpha, t_comp, lam, iters)


def market_clear(alpha: torch.Tensor, t_comp: torch.Tensor, b_total: float,
                 lam_prev: torch.Tensor, *, iters: int = 6,
                 inner_iters: int = 48, newton_inner_iters: int = 24
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole safeguarded-Newton market clear -> (b (N,), f (N,), lam ()).
    ``lam_prev`` is a 0-d float32 tensor on the tensors' device (<= 0 seeds
    cold).  On the card the kernel folds across blocks through mailboxes
    whose tags the host hands out at each launch: one stream at a time, and
    no CUDA-graph capture (it raises); a graph would need the tags from a
    counter on the device."""
    if lam_prev.ndim != 0:
        raise ValueError("market_clear: lam_prev must be a 0-d tensor")
    kwargs = dict(iters=iters, inner_iters=inner_iters,
                  newton_inner_iters=newton_inner_iters)
    if _on_cuda("market_clear", alpha, t_comp, lam_prev=lam_prev):
        out = market_clear_cuda(alpha, t_comp, float(b_total), lam_prev,
                                **kwargs)
        LAUNCHES["market_clear"] += 1
        return out
    return market_clear_plain(alpha, t_comp, float(b_total), lam_prev, **kwargs)


def mbdf_demand(alpha: torch.Tensor, t_comp: torch.Tensor,
                prices: torch.Tensor, alpha_fair: float, *,
                iters: int = 48) -> torch.Tensor:
    """Modified bandwidth demand d_n(p_m) on an (N, M) price grid (ascending
    in m) -> (N, M)."""
    if _on_cuda("mbdf_demand", alpha, t_comp, grid=prices):
        out = mbdf_demand_cuda(alpha, t_comp, prices, float(alpha_fair),
                               iters)
        LAUNCHES["mbdf_demand"] += 1
        return out
    return mbdf_demand_plain(alpha, t_comp, prices, float(alpha_fair), iters)


def _check_heads(name: str, tensors: dict, d: int) -> bool:
    """Validate the attention tensors' dtype, device and layout; True for
    the CUDA path, False for CPU."""
    first = next(iter(tensors.values()))
    if first.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"{name}: need float32 or bfloat16, got {first.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    for key, x in tensors.items():
        if x.dtype != first.dtype:
            raise TypeError(f"{name}: {key} is {x.dtype}, not {first.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name}: {key} is on {x.device}, not "
                             f"{first.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {key}'s head dim must be contiguous")
    if first.device.type == "cuda":
        return True
    if first.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {first.device}")


def _check_rows_aligned(name: str, tensors: dict) -> None:
    """The attention and bf16 mLSTM kernels read rows 16 bytes at a time
    (B5's bf16 path by TMA, B6 and B7's bf16 path by cp.async): every
    pointer and (batch, head, position) stride must keep rows 16-byte
    aligned."""
    for key, x in tensors.items():
        if x.data_ptr() % 16 or any(
                (st * x.element_size()) % 16 for st in x.stride()[:-1]):
            raise ValueError(f"{name}: {key}'s rows must be 16-byte aligned "
                             f"(strides {x.stride()})")


def _check_tma_strides(name: str, tensors: dict) -> None:
    """B5's bf16 path loads k and v through TMA tensor maps, which step
    every (batch, head, position) dim of extent > 1 by a positive stride:
    no broadcast (stride 0) views."""
    for key, x in tensors.items():
        if any(st <= 0 < n - 1 for st, n in zip(x.stride()[:-1],
                                                 x.shape[:-1])):
            raise ValueError(f"{name}: {key} has a stride-0 dim "
                             f"(strides {x.stride()}, shape "
                             f"{tuple(x.shape)}); TMA cannot broadcast")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA over a whole sequence (prefill).
    q (B, Hq, S, D), k and v (B, Hkv, S, D), any (batch, head, position)
    strides -> (B, Hq, S, D) in q's dtype and layout."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attention: need q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or s < 1:
        raise ValueError(f"attention: k and v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"attention: Hq {hq} is not a multiple of Hkv "
                         f"{k.shape[1]}")
    if window < 0:
        raise ValueError(f"attention: window must be >= 0, got {window}")
    if _check_heads("attention", {"q": q, "k": k, "v": v}, d):
        if q.dtype == torch.bfloat16:
            _check_rows_aligned("attention", {"q": q, "k": k, "v": v})
            _check_tma_strides("attention", {"k": k, "v": v})
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
        return out
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """One query token per sequence against a KV cache: q (B, Hq, D), k and
    v (B, S, Hkv, D) with any (batch, position, head) strides; the first
    ``valid_len`` keys (a host int, 1 <= valid_len <= S) take part ->
    (B, Hq, D) in q's dtype."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attention_decode: need q (B, Hq, D) and k, v "
                         f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or hkv < 1 or hq % hkv:
        raise ValueError(f"attention_decode: k and v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq // hkv not in DECODE_GROUPS:
        raise ValueError(f"attention_decode: {hq // hkv} query heads per KV "
                         f"head, not in {DECODE_GROUPS}")
    if isinstance(valid_len, torch.Tensor) or not 1 <= valid_len <= s:
        raise ValueError(f"attention_decode: valid_len must be a host int in "
                         f"[1, {s}], got {valid_len!r}")
    if _check_heads("attention_decode", {"q": q, "k": k, "v": v}, d):
        _check_rows_aligned("attention_decode", {"q": q, "k": k, "v": v})
        out = decode_attention_cuda(q, k, v, int(valid_len))
        LAUNCHES["decode_attention"] += 1
        return out
    return decode_attention_plain(q, k, v, int(valid_len))


def _check_mlstm(tensors: dict) -> bool:
    """Validate the mLSTM inputs' dtype, device and layout (the head dim of
    q, k and v contiguous); True for the CUDA path, False for CPU."""
    first = tensors["q"]
    if first.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"mlstm: need float32 or bfloat16, got {first.dtype}")
    for key, x in tensors.items():
        if x.dtype != first.dtype:
            raise TypeError(f"mlstm: {key} is {x.dtype}, not {first.dtype}")
        if x.device != first.device:
            raise ValueError(f"mlstm: {key} is on {x.device}, not "
                             f"{first.device}")
        if x.ndim == 4 and x.stride(-1) != 1:
            raise ValueError(f"mlstm: {key}'s head dim must be contiguous")
    if first.device.type == "cuda":
        return True
    if first.device.type == "cpu":
        return False
    raise ValueError(f"mlstm: unsupported device {first.device}")


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_gate: torch.Tensor, f_gate: torch.Tensor, state=None):
    """Chunkwise mLSTM over a whole sequence: q, k, v (B, H, S, Dh) with any
    (batch, head, position) strides and a contiguous head dim, gates
    (B, H, S) with any strides, all of one dtype; ``state`` None or
    float32 contiguous (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)) ->
    (y (B, H, S, Dh) in q's dtype, (C, n, m) float32)."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm: need q, k, v of one (B, H, S, Dh) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    if i_gate.shape != (b, h, s) or f_gate.shape != (b, h, s) or s < 1:
        raise ValueError(f"mlstm: gates must be ({b}, {h}, {s}) with S >= 1, "
                         f"got {tuple(i_gate.shape)}, {tuple(f_gate.shape)}")
    if dh % MLSTM_HEAD_DIM_STEP or not 0 < dh <= MLSTM_MAX_HEAD_DIM:
        raise ValueError(f"mlstm: head dim {dh} is not a multiple of "
                         f"{MLSTM_HEAD_DIM_STEP} up to {MLSTM_MAX_HEAD_DIM}")
    if state is not None:
        shapes = ((b, h, dh, dh), (b, h, dh), (b, h))
        if len(state) != 3 or any(
                x.shape != shape or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()
                for x, shape in zip(state, shapes)):
            raise ValueError(f"mlstm: state must be contiguous float32 "
                             f"(C, n, m) of shapes {shapes} on {q.device}")
    if _check_mlstm({"q": q, "k": k, "v": v, "i_gate": i_gate,
                     "f_gate": f_gate}):
        if q.dtype == torch.bfloat16:  # the tensor-core kernels' cp.async
            _check_rows_aligned("mlstm", {"q": q, "k": k, "v": v})
        out = mlstm_chunk_cuda(q, k, v, i_gate, f_gate, state)
        LAUNCHES["mlstm_chunk"] += 1
        return out
    return mlstm_chunk_plain(q, k, v, i_gate, f_gate, state)
