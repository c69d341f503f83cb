"""Dispatch wrappers for the allocation, attention and mLSTM kernels.

The device of the tensors decides the path: a CUDA tensor launches the
hand-written kernel (and raises if it cannot), a CPU tensor takes the plain
PyTorch version beside the kernel.  There is no fallback from one to the
other and no switch to force either.  Every wrapper checks device, dtype
(float32 for the allocation kernels, float32 or bfloat16 for attention
and the mLSTM), shape and layout first, and counts its kernel launches in
``LAUNCHES`` (a plain integer per kernel, bumped only where the kernel is
launched), so a run can show which kernels its main path went through.

The model kernels are ``torch.library`` custom ops
(``repro_torch::flash_attention``, ``::flash_attention_bwd``,
``::decode_attention``, ``::mlstm_chunk``): each op's implementation
launches the kernel for CUDA tensors and runs the plain version for CPU
ones, and checks strides, contiguity and alignment there, on real
tensors (under ``torch.func`` the wrappers see tensors without strides).
B5 differentiates through its own backward kernels: ``attention`` calls
``FlashAttention``, an ``autograd.Function`` (``torch.func`` needs one
with ``setup_context``; the custom op's own ``register_autograd`` shares
its context and backward) whose backward is the ``flash_attention_bwd``
op.  The forward op returns the output and each row's log-sum-exp L,
which it saves (not differentiable) for the backward op, so the backward
does not recompute it; ``attention`` returns the output alone.  B7 does
the same through ``MLSTMChunk``: its forward op, asked to ``save``,
returns the state at every chunk's start and the per-position
statistics of the normaliser for its backward op
(``repro_torch::mlstm_chunk_bwd``).  Every op folds a vmapped dim into
the batch (``register_vmap``), so ``vmap(grad(loss))`` over clients and
services launches each kernel once a layer.  B6 has no backward (decode
is never differentiated): on a CUDA tensor that requires grad its
wrapper raises (ROADMAP).
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.bisect_alloc import bisect_alloc_cuda, bisect_alloc_plain
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.dual_demand import dual_demand_cuda, dual_demand_plain
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain_lse)
from repro_torch.kernels.market_clear import (market_clear_cuda,
                                              market_clear_plain,
                                              mbdf_demand_cuda,
                                              mbdf_demand_plain)
from repro_torch.kernels.mlstm_chunk import CHUNK as MLSTM_CHUNK
from repro_torch.kernels.mlstm_chunk import (mlstm_chunk_bwd_cuda,
                                             mlstm_chunk_bwd_plain,
                                             mlstm_chunk_cuda,
                                             mlstm_chunk_fwd_plain,
                                             mlstm_chunk_plain)

KERNEL_NAMES = ("bisect_alloc", "dual_demand", "market_clear", "mbdf_demand",
                "flash_attention", "flash_attention_bwd", "decode_attention",
                "mlstm_chunk", "mlstm_chunk_bwd")
MAX_K = 1024  # clients per service the kernels hold in registers (32 x 32)
HEAD_DIMS = (32, 64, 128, 256)     # head dims the attention kernels compile
DECODE_GROUPS = tuple(range(1, 9))  # query heads per KV head of decode
ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
MLSTM_HEAD_DIM_STEP = 64    # mLSTM head dims: multiples of the kernel's
MLSTM_MAX_HEAD_DIM = 1024   # head-dim tile, up to what its C slice fits

# Launches per kernel; "mlstm_chunk" counts calls, each of which launches
# the states and the outputs kernel in bfloat16 (one kernel in float32);
# "flash_attention_bwd" counts calls, each of which launches Delta, dk and
# dv, then dq in bfloat16 (dq, then dk and dv in float32);
# "mlstm_chunk_bwd" counts calls of its four kernels (scores, states,
# grads, gates).
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, alpha: torch.Tensor, t_comp: torch.Tensor,
             mask: torch.Tensor, grid: torch.Tensor | None = None,
             **vectors: torch.Tensor) -> bool:
    """Validate a kernel's inputs; True for the CUDA path, False for CPU.
    ``mask`` (bool) marks each row's clients; ``vectors`` are scalars or
    (N,); ``grid`` an (N, M) matrix."""
    if (alpha.ndim != 2 or t_comp.shape != alpha.shape
            or mask.shape != alpha.shape):
        raise ValueError(f"{name}: alpha, t_comp and mask must share one "
                         f"(N, K) shape, got {tuple(alpha.shape)}, "
                         f"{tuple(t_comp.shape)} and {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
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
    for key, x in {**tensors, "mask": mask}.items():
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


def intra_allocate(alpha: torch.Tensor, t_comp: torch.Tensor,
                   mask: torch.Tensor, b: torch.Tensor, *, iters: int = 48
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7 per service -> (t* (N,), per-client split (N, K)).  In this
    and the other allocation wrappers ``mask`` marks each row's clients
    (``ServiceSet.mask``), whatever their alpha."""
    if b.ndim != 1:
        raise ValueError(f"intra_allocate: b must be (N,), got {tuple(b.shape)}")
    if _on_cuda("intra_allocate", alpha, t_comp, mask, b=b):
        out = bisect_alloc_cuda(alpha, t_comp, mask, b, iters)
        LAUNCHES["bisect_alloc"] += 1
        return out
    return bisect_alloc_plain(alpha, t_comp, mask, b, iters)


def dual_demand(alpha: torch.Tensor, t_comp: torch.Tensor, mask: torch.Tensor,
                lam: torch.Tensor, *, iters: int = 48
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-service demand b_n(lam) and slope db_n/dlam -> ((N,), (N,)).
    ``lam`` is a 0-d or (N,) float32 tensor on the tensors' device."""
    if _on_cuda("dual_demand", alpha, t_comp, mask, lam=lam):
        out = dual_demand_cuda(alpha, t_comp, mask, lam, iters)
        LAUNCHES["dual_demand"] += 1
        return out
    return dual_demand_plain(alpha, t_comp, mask, lam, iters)


def market_clear(alpha: torch.Tensor, t_comp: torch.Tensor,
                 mask: torch.Tensor, b_total: float, lam_prev: torch.Tensor,
                 *, iters: int = 6, inner_iters: int = 48,
                 newton_inner_iters: int = 24
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
    if _on_cuda("market_clear", alpha, t_comp, mask, lam_prev=lam_prev):
        out = market_clear_cuda(alpha, t_comp, mask, float(b_total),
                                lam_prev, **kwargs)
        LAUNCHES["market_clear"] += 1
        return out
    return market_clear_plain(alpha, t_comp, mask, float(b_total), lam_prev,
                              **kwargs)


def mbdf_demand(alpha: torch.Tensor, t_comp: torch.Tensor, mask: torch.Tensor,
                prices: torch.Tensor, alpha_fair: float, *,
                iters: int = 48) -> torch.Tensor:
    """Modified bandwidth demand d_n(p_m) on an (N, M) price grid (ascending
    in m) -> (N, M)."""
    if _on_cuda("mbdf_demand", alpha, t_comp, mask, grid=prices):
        out = mbdf_demand_cuda(alpha, t_comp, mask, prices,
                               float(alpha_fair), iters)
        LAUNCHES["mbdf_demand"] += 1
        return out
    return mbdf_demand_plain(alpha, t_comp, mask, prices, float(alpha_fair),
                             iters)


def _check_heads(name: str, tensors: dict, d: int) -> bool:
    """Validate the attention tensors' dtype, head dim and device (what a
    ``torch.func`` tensor shows); True for the CUDA path, False for CPU."""
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
    return _kernel_device(name, first)


def _kernel_device(name: str, x: Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _check_head_dim_contiguous(name: str, tensors: dict) -> None:
    for key, x in tensors.items():
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {key}'s head dim must be contiguous")


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


def _broadcast(x: Tensor) -> bool:
    """A (batch, head, position) dim of extent > 1 with stride <= 0."""
    return any(st <= 0 < n - 1 for st, n in zip(x.stride()[:-1],
                                                 x.shape[:-1]))


def _check_tma_strides(name: str, tensors: dict) -> None:
    """B5's bf16 path loads k and v (the backward also q and dO) through
    TMA tensor maps, which step every (batch, head, position) dim of extent
    > 1 by a positive stride: no broadcast (stride 0) views."""
    for key, x in tensors.items():
        if _broadcast(x):
            raise ValueError(f"{name}: {key} has a stride-0 dim "
                             f"(strides {x.stride()}, shape "
                             f"{tuple(x.shape)}); TMA cannot broadcast")


def _dense_for_tma(x: Tensor) -> Tensor:
    """The backward's q, o and dO in a layout its kernels read: a dense
    copy where they could not read ``x`` as it is (a head dim that is not
    contiguous, a stride-0 dim, a row that is not 16-byte aligned).
    autograd, not the caller, picks dO's layout (the gradient of a sum is
    an expanded view; through ``out.sum(0)``, a batch stride of 0), and
    ``vmap`` folds an unbatched q into a stride-0 batch that the forward
    reads but TMA, which loads q in the backward, cannot."""
    if x.stride(-1) != 1 or _broadcast(x) or x.data_ptr() % 16 \
            or any((st * x.element_size()) % 16 for st in x.stride()[:-1]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _refuse_grad(name: str, item: str, tensors: dict) -> None:
    """A kernel without a backward must not hand autograd a tensor it
    cannot differentiate: raise on a CUDA tensor that requires grad."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward "
                           f"({item}); call it under torch.no_grad() or on "
                           f"tensors that do not require grad")


# ---------------------------------------------------------------------------
# B5: flash attention and its backward, as custom ops.
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int, softcap: float) -> tuple[Tensor, Tensor]:
    """B5 on real tensors -> ((B, Hq, Sq, D) in q's dtype and layout, L
    (B, Hq, Sq) float32, each row's log-sum-exp): the kernel for CUDA
    tensors, the plain version for CPU ones."""
    _check_head_dim_contiguous("attention", {"q": q, "k": k, "v": v})
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _kernel_device("attention", q):
        if q.dtype == torch.bfloat16:
            _check_rows_aligned("attention", {"q": q, "k": k, "v": v})
            _check_tma_strides("attention", {"k": k, "v": v})
        out = flash_attention_cuda(q, k, v, **kw)
        LAUNCHES["flash_attention"] += 1
        return out
    out, lse = flash_attention_plain_lse(q, k, v, **kw)
    return torch.empty_like(q).copy_(out), lse


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                           lse: Tensor, dout: Tensor, causal: bool,
                           window: int, softcap: float
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """B5's backward on real tensors -> (dq, dk, dv) in the layouts of q, k
    and v: the kernels for CUDA tensors, the plain version for CPU ones.
    ``o`` and ``lse`` are the forward's outputs, ``dout`` o's gradient."""
    _check_head_dim_contiguous("attention backward", {"k": k, "v": v})
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _kernel_device("attention backward", q):
        q_in = q
        q, o, dout = (_dense_for_tma(x) for x in (q, o, dout))
        lse = lse.contiguous()
        if q.dtype == torch.bfloat16:
            tensors = {"k": k, "v": v}
            _check_rows_aligned("attention backward", tensors)
            _check_tma_strides("attention backward", tensors)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, dout, **kw)
        LAUNCHES["flash_attention_bwd"] += 1
        if q is not q_in:  # dq in q's own layout, as the fake gives it
            dq = torch.empty_like(q_in).copy_(dq)
        return dq, dk, dv
    return tuple(torch.empty_like(x).copy_(g) for x, g in zip(
        (q, k, v), flash_attention_bwd_plain(q, k, v, o, lse, dout, **kw)))


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, dout, causal, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.options = (causal, window, softcap)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = FlashAttentionBackward.apply(q, k, v, o, lse, dout,
                                              *ctx.options)
    return dq, dk, dv, None, None, None


class FlashAttentionBackward(torch.autograd.Function):
    """B5's backward op as autograd sees it: a first derivative runs it, a
    second one (``torch.func.grad`` of a grad, ``create_graph=True``)
    raises instead of taking attention's curvature as zero."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, o, lse, dout, causal, window, softcap):
        return flash_attention_bwd_op(q, k, v, o, lse, dout, causal, window,
                                      softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("attention: no second derivative through B5's "
                           "backward (ROADMAP Queue B, B5)")


flash_attention_op.register_autograd(_flash_backward,
                                     setup_context=_flash_setup_context)


def _fold_batch(info, in_dims, tensors) -> list:
    """Each tensor with its vmapped dim moved first (an unbatched one
    expanded) and folded into the batch dim: (n, B, ...) -> (n B, ...)."""
    n = info.batch_size
    out = []
    for x, dim in zip(tensors, in_dims):
        x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
        out.append(x.reshape(n * x.shape[1], *x.shape[2:]))
    return out


def _unfold(x: Tensor, n: int) -> Tensor:
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _flash_vmap(info, in_dims, q, k, v, causal, window, softcap):
    q, k, v = _fold_batch(info, in_dims[:3], (q, k, v))
    outs = flash_attention_op(q, k, v, causal, window, softcap)
    return tuple(_unfold(x, info.batch_size) for x in outs), (0, 0)


def _flash_bwd_vmap(info, in_dims, q, k, v, o, lse, dout, causal, window,
                    softcap):
    grads = flash_attention_bwd_op(
        *_fold_batch(info, in_dims[:6], (q, k, v, o, lse, dout)), causal,
        window, softcap)
    return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


flash_attention_op.register_vmap(_flash_vmap)
flash_attention_bwd_op.register_vmap(_flash_bwd_vmap)


class FlashAttention(torch.autograd.Function):
    """B5 as autograd sees it, under plain autograd and ``torch.func`` alike:
    the forward op (its L saved, not differentiable), the backward op;
    ``vmap`` runs both through their folding rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window, softcap):
        return flash_attention_op(q, k, v, causal, window, softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _flash_setup_context(ctx, inputs, output)

    @staticmethod
    def backward(ctx, dout, dlse):
        return _flash_backward(ctx, dout, dlse)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """Causal / sliding-window GQA over a whole sequence (prefill), or
    without the causal mask over keys of their own length (an encoder,
    cross-attention).  q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) with
    Skv = Sq under the causal mask, any (batch, head, position) strides ->
    (B, Hq, Sq, D) in q's dtype and layout.  ``softcap`` > 0 soft-caps the
    scaled logits.  Differentiable (B5's backward kernels on the card),
    under ``torch.func`` too."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attention: need q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    skv = k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or s < 1 or skv < 1 or (
            causal and skv != s):
        raise ValueError(f"attention: k and v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}"
                         f"{' (causal: Skv must equal Sq)' if causal else ''}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"attention: Hq {hq} is not a multiple of Hkv "
                         f"{k.shape[1]}")
    if window < 0 or softcap < 0:
        raise ValueError(f"attention: window and softcap must be >= 0, got "
                         f"{window} and {softcap}")
    _check_heads("attention", {"q": q, "k": k, "v": v}, d)
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                float(softcap))[0]


# ---------------------------------------------------------------------------
# B6 (no backward) and B7 and its backward as custom ops.
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_op(q: Tensor, k: Tensor, v: Tensor, valid_len: int,
                        softcap: float) -> Tensor:
    """B6 on real tensors -> (B, Hq, D) in q's dtype: the kernel for CUDA
    tensors, the plain version for CPU ones."""
    _check_head_dim_contiguous("attention_decode", {"q": q, "k": k, "v": v})
    if _kernel_device("attention_decode", q):
        _check_rows_aligned("attention_decode", {"q": q, "k": k, "v": v})
        out = decode_attention_cuda(q, k, v, valid_len, softcap=softcap)
        LAUNCHES["decode_attention"] += 1
        return out
    return decode_attention_plain(q, k, v, valid_len,
                                  softcap=softcap).contiguous()


@decode_attention_op.register_fake
def _(q, k, v, valid_len, softcap):
    return q.new_empty(q.shape)


def attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int, *, softcap: float = 0.0
                     ) -> torch.Tensor:
    """One query token per sequence against a KV cache: q (B, Hq, D), k and
    v (B, S, Hkv, D) with any (batch, position, head) strides; the first
    ``valid_len`` keys (a host int, 1 <= valid_len <= S) take part ->
    (B, Hq, D) in q's dtype.  ``softcap`` > 0 soft-caps the scaled
    logits.  Decode is never differentiated (as in the JAX package): on
    the card, inputs that require grad raise."""
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
    if softcap < 0:
        raise ValueError(f"attention_decode: softcap must be >= 0, got "
                         f"{softcap}")
    tensors = {"q": q, "k": k, "v": v}
    if _check_heads("attention_decode", tensors, d):
        _refuse_grad("attention_decode", "decode is never differentiated, "
                     "as in the JAX package; ROADMAP Queue B, B6", tensors)
        _check_head_dim_contiguous("attention_decode", tensors)
        _check_rows_aligned("attention_decode", tensors)
    return decode_attention_op(q, k, v, int(valid_len), float(softcap))


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
    return _kernel_device("mlstm", first)


@torch.library.custom_op("repro_torch::mlstm_chunk", mutates_args=())
def mlstm_chunk_op(q: Tensor, k: Tensor, v: Tensor, i_gate: Tensor,
                   f_gate: Tensor, c0: Tensor | None, n0: Tensor | None,
                   m0: Tensor | None, save: bool = False
                   ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                              Tensor, Tensor]:
    """B7 on real tensors -> (y (B, H, S, Dh) in q's dtype, a view of a
    (B, S, H, Dh) buffer; C, n, m float32; then what the backward reads:
    C_c (B, H, n_chunks, Dh, Dh) in q's dtype, n_c (B, H, n_chunks, Dh),
    m_c (B, H, n_chunks), the state at every ``CHUNK``'s start, and the
    per-position statistics (B, H, 2, S), all float32; empty (0,) tensors
    unless ``save``): the kernels for CUDA tensors, the plain version for
    CPU ones.  (c0, n0, m0) is the initial state, or three Nones."""
    state = None if c0 is None else (c0, n0, m0)
    if _kernel_device("mlstm", q):
        if q.dtype == torch.bfloat16:  # the tensor-core kernels' cp.async
            _check_rows_aligned("mlstm", {"q": q, "k": k, "v": v})
        out = mlstm_chunk_cuda(q, k, v, i_gate, f_gate, state, save=save)
        LAUNCHES["mlstm_chunk"] += 1
    elif save:
        y, final, (cs, ns, ms), stats = mlstm_chunk_fwd_plain(
            q, k, v, i_gate, f_gate, state)
        out = (_mlstm_y(q).copy_(y), final, (cs.to(q.dtype), ns, ms), stats)
    else:
        y, final = mlstm_chunk_plain(q, k, v, i_gate, f_gate, state)
        out = (_mlstm_y(q).copy_(y), final)
    y, (c, n, m) = out[:2]
    saved = (*out[2], out[3]) if save else tuple(
        q.new_empty((0,), dtype=torch.float32) for _ in range(4))
    return (y, *(x.contiguous() for x in (c, n, m)), *saved)


def _mlstm_y(q: Tensor) -> Tensor:
    b, h, s, dh = q.shape
    return q.new_empty((b, s, h, dh)).transpose(1, 2)


def _mlstm_saved_shapes(q: Tensor) -> tuple:
    b, h, s, dh = q.shape
    nc = -(-s // MLSTM_CHUNK)
    return ((b, h, nc, dh, dh), (b, h, nc, dh), (b, h, nc), (b, h, 2, s))


@mlstm_chunk_op.register_fake
def _(q, k, v, i_gate, f_gate, c0, n0, m0, save=False):
    b, h, _, dh = q.shape
    f32 = dict(dtype=torch.float32)
    if save:
        shapes = _mlstm_saved_shapes(q)
        saved = (q.new_empty(shapes[0]),
                 *(q.new_empty(x, **f32) for x in shapes[1:]))
    else:
        saved = tuple(q.new_empty((0,), **f32) for _ in range(4))
    return (_mlstm_y(q), q.new_empty((b, h, dh, dh), **f32),
            q.new_empty((b, h, dh), **f32), q.new_empty((b, h), **f32),
            *saved)


@torch.library.custom_op("repro_torch::mlstm_chunk_bwd", mutates_args=())
def mlstm_chunk_bwd_op(q: Tensor, k: Tensor, v: Tensor, i_gate: Tensor,
                       f_gate: Tensor, y: Tensor, cs: Tensor, ns: Tensor,
                       ms: Tensor, m_last: Tensor, stats: Tensor, dy: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """B7's backward on real tensors -> (dq, dk, dv (B, H, S, Dh) in q's
    dtype, di, df (B, H, S) in the gates' dtype), all contiguous: the
    kernels for CUDA tensors, the plain version for CPU ones.  ``y``,
    (cs, ns, ms), ``m_last`` (the final m) and ``stats`` are the forward
    op's outputs, ``dy`` y's gradient."""
    if dy.stride(-1) != 1 or _broadcast(dy):  # autograd picks dy's layout
        dy = dy.contiguous()
    args = (q, k, v, i_gate, f_gate, y, (cs, ns, ms), m_last, stats, dy)
    if _kernel_device("mlstm backward", q):
        _check_mlstm_saved(q, {"i_gate": i_gate, "f_gate": f_gate, "y": y,
                               "dy": dy}, (cs, ns, ms, m_last, stats))
        grads = mlstm_chunk_bwd_cuda(*args)
        LAUNCHES["mlstm_chunk_bwd"] += 1
        return grads
    return tuple(g.contiguous() for g in mlstm_chunk_bwd_plain(*args))


def _check_mlstm_saved(q: Tensor, tensors: dict, saved: tuple) -> None:
    """The backward kernels read what the forward saved: its shapes and
    dtypes, on q's device, the inputs and y, dy of q's (gates') shape."""
    b, h, s, _ = q.shape
    c_c, n_c, m_c, stats = _mlstm_saved_shapes(q)
    shapes = (c_c, n_c, m_c, (b, h), stats)
    dtypes = (q.dtype,) + (torch.float32,) * 4
    for x, shape, dtype in zip(saved, shapes, dtypes):
        if tuple(x.shape) != shape or x.dtype != dtype or \
                x.device != q.device:
            raise ValueError(f"mlstm backward: saved tensors must be "
                             f"{shapes} of {dtypes} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")
    for key, x in tensors.items():
        want = (b, h, s) if key.endswith("gate") else tuple(q.shape)
        if tuple(x.shape) != want or x.dtype != q.dtype or \
                x.device != q.device or (x.ndim == 4 and x.stride(-1) != 1):
            raise ValueError(f"mlstm backward: {key} must be {want} "
                             f"{q.dtype} on {q.device} with a contiguous "
                             f"head dim")


@mlstm_chunk_bwd_op.register_fake
def _(q, k, v, i_gate, f_gate, y, cs, ns, ms, m_last, stats, dy):
    return (*(q.new_empty(q.shape) for _ in range(3)),
            *(i_gate.new_empty(i_gate.shape) for _ in range(2)))


class MLSTMChunkBackward(torch.autograd.Function):
    """B7's backward op as autograd sees it: a second derivative raises,
    as B5's does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        return mlstm_chunk_bwd_op(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("mlstm: no second derivative through B7's "
                           "backward (ROADMAP Queue B, B7)")


class MLSTMChunk(torch.autograd.Function):
    """B7 as autograd sees it, under plain autograd and ``torch.func``
    alike: the forward op with ``save`` (its chunk states and statistics
    saved, not differentiable), the backward op; ``vmap`` runs both
    through their folding rules.  Only y is differentiated: a gradient for
    the returned state (C, n, m) raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, i_gate, f_gate, c0, n0, m0):
        return mlstm_chunk_op(q, k, v, i_gate, f_gate, c0, n0, m0, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, i_gate, f_gate = inputs[:5]
        y, _, _, m, cs, ns, ms, stats = output
        ctx.mark_non_differentiable(cs, ns, ms, stats)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_gate, f_gate, y, cs, ns, ms, m,
                              stats)

    @staticmethod
    def backward(ctx, dy, dc, dn, dm, *_saved):
        if dc is not None or dn is not None or dm is not None:
            raise RuntimeError("mlstm: no gradient through the returned "
                               "state (C, n, m); only y is differentiated "
                               "(ROADMAP Queue B, B7)")
        if dy is None:
            return (None,) * 8
        grads = MLSTMChunkBackward.apply(*ctx.saved_tensors, dy)
        return (*grads, None, None, None)


def _mlstm_vmap(info, in_dims, q, k, v, i_gate, f_gate, c0, n0, m0,
                save=False):
    args = _fold_batch(info, in_dims[:5], (q, k, v, i_gate, f_gate))
    state = (None,) * 3
    if c0 is not None:
        state = tuple(x.contiguous() for x in _fold_batch(
            info, in_dims[5:8], (c0, n0, m0)))
    out = mlstm_chunk_op(*args, *state, save)
    return tuple(_unfold(x, info.batch_size) for x in out), (0,) * 8


def _mlstm_bwd_vmap(info, in_dims, *args):
    grads = mlstm_chunk_bwd_op(*_fold_batch(info, in_dims, args))
    return tuple(_unfold(g, info.batch_size) for g in grads), (0,) * 5


mlstm_chunk_op.register_vmap(_mlstm_vmap)
mlstm_chunk_bwd_op.register_vmap(_mlstm_bwd_vmap)


def _needs_grad(tensors) -> bool:
    """Whether a call may be differentiated: grad mode on and an input that
    requires grad, or a ``torch.func.grad`` (or ``vjp``) level around the
    call (under ``grad(vmap(f))`` the tensors ``f`` sees do not say they
    require grad).  ``vmap`` alone does not count."""
    if not torch.is_grad_enabled():
        return False
    if any(x.requires_grad for x in tensors):
        return True
    stack = torch._C._functorch.get_interpreter_stack() or ()
    return any(level.key() == torch._C._functorch.TransformType.Grad
               for level in stack)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_gate: torch.Tensor, f_gate: torch.Tensor, state=None):
    """Chunkwise mLSTM over a whole sequence: q, k, v (B, H, S, Dh) with any
    (batch, head, position) strides and a contiguous head dim, gates
    (B, H, S) with any strides, all of one dtype; ``state`` None or
    float32 contiguous (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)) ->
    (y (B, H, S, Dh) in q's dtype, (C, n, m) float32).  Differentiable in
    y (B7's backward kernels on the card, their plain versions on the CPU,
    through ``MLSTMChunk``), under ``torch.func`` too; a state that
    requires grad, and a gradient for the returned state, raise.  A CPU
    call that is not differentiated takes the plain version directly."""
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
    tensors = {"q": q, "k": k, "v": v, "i_gate": i_gate, "f_gate": f_gate}
    on_card = _check_mlstm(tensors)
    grad = _needs_grad(tensors.values())
    if grad and state is not None and any(x.requires_grad for x in state):
        raise RuntimeError("mlstm: no gradient to the initial state (C, n, "
                           "m); pass it detached (ROADMAP Queue B, B7)")
    if grad:
        y, c, n, m = MLSTMChunk.apply(q, k, v, i_gate, f_gate,
                                      *(state or (None, None, None)))[:4]
        return y, (c, n, m)
    if not on_card:
        return mlstm_chunk_plain(q, k, v, i_gate, f_gate, state)
    y, c, n, m = mlstm_chunk_op(q, k, v, i_gate, f_gate,
                                *(state or (None, None, None)), False)[:4]
    return y, (c, n, m)
