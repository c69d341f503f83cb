"""Gradients through the port's models against the JAX package's.

* B5's backward: ``flash_attention_bwd_plain`` (the CPU body of the
  ``repro_torch::flash_attention_bwd`` op, the formula the CUDA kernels
  compute, P formed from the forward's log-sum-exp L) against
  ``torch.autograd`` of ``flash_attention_plain`` and against ``jax.vjp``
  of the JAX reference attention (``repro.models.layers.chunked_attention``),
  over head dims, groups, masks, the soft cap and ragged lengths, in
  float32.  Tolerance: 1e-5 of the largest |grad| of each output.
* The forward op's L against a float64 numpy log-sum-exp of the masked,
  soft-capped logits, within 1e-6 of the largest |L|.
* The ``torch.func`` plumbing: ``torch.library.opcheck`` on the custom
  ops; ``vmap(grad(...))`` through ``ops.attention``, once and nested,
  equal to a loop over the batch; a dO with a stride-0 batch dim, and in
  bfloat16 a q that ``vmap`` folded into a stride-0 batch, reach the
  backward's launcher dense; B6 refuses grad on the card, and grad
  through ``ops.mlstm`` routed as on the card reaches B7's backward
  launcher once, with a dense dy.
* ``torch.func.grad(model.loss)`` against ``jax.grad(model.loss)`` on one
  parameter set (the JAX init carried over by ``interop``), for each family
  at smoke size, in float32.  Tolerance: per leaf, 2e-4 of the leaf's
  largest |grad| (the losses' own parity is 1e-4; a few layers of
  products and softmaxes sum in other orders).
* One ``make_fl_round_step`` round of gemma3-1b and of xlstm-1.3b, port
  against JAX, on the same params, batches and weights: params within
  1e-4 of each leaf's largest |value| change, the loss within 1e-5
  relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro import configs as j_configs
from repro.fl import server as j_server
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro_torch import configs, interop
from repro_torch.fl import server
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_attention_plain_lse)
from repro_torch.kernels.mlstm_chunk import (mlstm_chunk_bwd_plain,
                                             mlstm_chunk_fwd_plain,
                                             mlstm_chunk_plain)
from repro_torch.models import registry

ATTN_TOL = 1e-5
LSE_TOL = 1e-6
BF16_TOL = 2e-2     # of the largest |grad|, as on the card
GRAD_TOL = 2e-4

# (B, Hkv, G, Sq, Skv, D, causal, window, softcap)
ATTN_CASES = [
    (2, 1, 1, 33, 33, 32, True, 0, 0.0),
    (1, 2, 2, 40, 40, 64, True, 8, 0.0),
    (1, 1, 5, 37, 37, 128, True, 0, 50.0),
    (1, 1, 7, 20, 20, 256, True, 5, 0.0),
    (1, 1, 8, 17, 17, 64, True, 0, 0.0),
    (2, 2, 2, 19, 29, 32, False, 0, 0.0),
    (1, 2, 5, 21, 13, 64, False, 0, 50.0),
    (1, 1, 2, 45, 45, 256, True, 16, 50.0),
    (1, 3, 1, 70, 70, 32, True, 64, 0.0),
]


def _attn_inputs(case, seed=0):
    b, hkv, g, s, skv, d, causal, window, cap = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hkv * g, s, d), (b, hkv, skv, d),
                          (b, hkv, skv, d), (b, hkv * g, s, d))]
    return arrs, dict(causal=causal, window=window, softcap=cap)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_bwd_plain_matches_autograd_of_plain(case):
    (q, k, v, do), kw = _attn_inputs(case)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_plain_lse(q, k, v, **kw)
    want = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    out.detach(), lse.detach(),
                                    torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= ATTN_TOL


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_bwd_matches_jax_vjp_of_reference_attention(case):
    """The op's gradient through ``ops.attention`` (autograd: the backward
    op's CPU body) against jax.vjp of the JAX model's attention."""
    (q, k, v, do), kw = _attn_inputs(case, seed=1)
    t = (0, 2, 1, 3)   # (B, H, S, D) <-> (B, S, H, D)

    def j_attn(q, k, v):
        out = j_layers.chunked_attention(
            q.transpose(t), k.transpose(t), v.transpose(t),
            causal=kw["causal"], window=kw["window"],
            logit_softcap=kw["softcap"])
        return out.transpose(t)

    _, vjp = jax.vjp(j_attn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= ATTN_TOL


def test_custom_ops_pass_opcheck():
    rng = np.random.default_rng(2)

    def t(*shape, grad=False):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(grad)

    q, k, v = t(2, 4, 12, 32, grad=True), t(2, 2, 12, 32, grad=True), \
        t(2, 2, 12, 32, grad=True)
    torch.library.opcheck(ops.flash_attention_op, (q, k, v, True, 5, 0.0))
    torch.library.opcheck(ops.flash_attention_op, (q, k[:, :, :7],
                                                   v[:, :, :7], False, 0,
                                                   50.0))
    o, lse = (x.detach() for x in ops.flash_attention_op(q, k, v, True, 5,
                                                         0.0))
    torch.library.opcheck(ops.flash_attention_bwd_op,
                          (q.detach(), k.detach(), v.detach(), o, lse,
                           t(2, 4, 12, 32), True, 5, 0.0))
    o, lse = (x.detach() for x in ops.flash_attention_op(
        q, k[:, :, :7], v[:, :, :7], False, 0, 50.0))
    torch.library.opcheck(ops.flash_attention_bwd_op,
                          (q.detach(), k[:, :, :7].detach(),
                           v[:, :, :7].detach(), o, lse, t(2, 4, 12, 32),
                           False, 0, 50.0))
    torch.library.opcheck(ops.decode_attention_op,
                          (t(2, 4, 32), t(2, 9, 2, 32), t(2, 9, 2, 32), 6,
                           0.0))
    g = t(1, 2, 16)
    torch.library.opcheck(ops.mlstm_chunk_op,
                          (t(1, 2, 16, 64), t(1, 2, 16, 64),
                           t(1, 2, 16, 64), g, g + 3.0, None, None, None))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_op_lse_matches_float64_logsumexp(case):
    """The forward op's L (its CPU body, the formula the kernels write)
    against log sum exp of the masked, soft-capped logits in float64."""
    (q, k, v, _), kw = _attn_inputs(case, seed=3)
    out, lse = ops.flash_attention_op(*(torch.from_numpy(x)
                                         for x in (q, k, v)),
                                      kw["causal"], kw["window"],
                                      kw["softcap"])
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    x = np.einsum("bhgqd,bhkd->bhgqk",
                  q.astype(np.float64).reshape(b, hkv, hq // hkv, s, d),
                  k.astype(np.float64)) / np.sqrt(d)
    if kw["softcap"]:
        x = kw["softcap"] * np.tanh(x / kw["softcap"])
    rows, cols = np.arange(s)[:, None], np.arange(skv)[None, :]
    keep = np.ones((s, skv), bool)
    if kw["causal"]:
        keep &= rows >= cols
    if kw["window"]:
        keep &= rows - cols < kw["window"]
    x = np.where(keep, x, -np.inf)
    top = x.max(axis=-1, keepdims=True)
    want = (top[..., 0] + np.log(np.exp(x - top).sum(axis=-1))).reshape(
        b, hq, s)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert out.shape == q.shape
    assert _rel(lse.numpy(), want) <= LSE_TOL


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_broadcast_dout_reaches_the_kernel_dense(case, monkeypatch):
    """autograd hands the backward a dO with a batch stride of 0 (the
    gradient of (out.sum(0) * w).sum(): w expanded over the batch).  Routed
    as CUDA tensors (the device test patched, the launchers pointed at the
    plain versions), the op passes it on dense, and the gradients equal
    the plain version's."""
    seen = []

    def bwd_launcher(q, k, v, o, lse, dout, **kw):
        seen.append(dout.stride())
        assert dout.is_contiguous() and not ops._broadcast(dout)
        return flash_attention_bwd_plain(q, k, v, o, lse, dout, **kw)

    monkeypatch.setattr(ops, "_kernel_device", lambda name, x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        flash_attention_plain_lse)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd_launcher)
    (q, k, v, do), kw = _attn_inputs(case, seed=4)
    w = torch.from_numpy(do[0])         # (Hq, Sq, D), expanded over B
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(
        (ops.attention(tq, tk, tv, **kw).sum(0) * w).sum(), (tq, tk, tv))
    assert len(seen) == 1
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        (flash_attention_plain(pq, pk, pv, **kw).sum(0) * w).sum(),
        (pq, pk, pv))
    for g, wnt in zip(got, want):
        assert _rel(g.numpy(), wnt.numpy()) <= ATTN_TOL


@pytest.mark.parametrize("case", [c for c in ATTN_CASES if c[0] == 1],
                         ids=str)
def test_vmap_unbatched_q_reaches_the_bwd_kernel_dense(case, monkeypatch):
    """``vmap`` over k and v with q unbatched and B = 1 folds q into a
    stride-0 batch, which the forward reads.  Routed as CUDA tensors in
    bfloat16 (the device test patched, the launchers pointed at the plain
    versions, the TMA checks live), the backward op passes q, o and dO on
    dense instead of refusing q, and the gradients equal a loop's."""
    fwd_q_broadcast, seen = [], []

    def fwd_launcher(q, k, v, **kw):
        fwd_q_broadcast.append(ops._broadcast(q))
        return flash_attention_plain_lse(q, k, v, **kw)

    def bwd_launcher(q, k, v, o, lse, dout, **kw):
        seen.append(q.stride())
        assert not any(ops._broadcast(x) for x in (q, o, dout))
        return flash_attention_bwd_plain(q, k, v, o, lse, dout, **kw)

    monkeypatch.setattr(ops, "_kernel_device", lambda name, x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd_launcher)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd_launcher)
    (q, k, v, _), kw = _attn_inputs(case, seed=6)
    rng = np.random.default_rng(7)
    ks, vs = (torch.from_numpy(rng.standard_normal((3, *x.shape)).astype(
        np.float32)).bfloat16() for x in (k, v))
    tq = torch.from_numpy(q).bfloat16()

    def loss(q, k, v):
        return torch.sum(ops.attention(q, k, v, **kw).float() ** 2)

    got = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(None, 0, 0))(tq, ks,
                                                                   vs)
    assert fwd_q_broadcast == [True] and len(seen) == 1
    want = [torch.stack(g) for g in zip(*(
        grad(loss, argnums=(0, 1, 2))(tq, ks[i], vs[i]) for i in range(3)))]
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape and g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), wnt.float().numpy()) <= BF16_TOL


def _attn_loss(w, x):
    h = (x @ w).reshape(x.shape[0], x.shape[1], 2, 32).transpose(1, 2)
    k = h[:, :1]
    return torch.sum(ops.attention(h, k, k, window=6, softcap=30.0) ** 2)


def test_vmap_of_grad_through_attention_equals_a_loop():
    ops.reset_launches()
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((3, 2, 11, 48)).astype(
        np.float32))
    got = vmap(grad(_attn_loss), in_dims=(None, 0))(w, xs)
    want = torch.stack([grad(_attn_loss)(w, x) for x in xs])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    nested = torch.from_numpy(rng.standard_normal((2, 3, 2, 11, 48)).astype(
        np.float32))
    ws = torch.from_numpy(rng.standard_normal((2, 48, 64)).astype(np.float32))
    got = vmap(vmap(grad(_attn_loss), in_dims=(None, 0)))(ws, nested)
    for i in range(2):
        want = torch.stack([grad(_attn_loss)(ws[i], x) for x in nested[i]])
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)
    assert ops.LAUNCHES["flash_attention_bwd"] == 0   # the CPU launches none


@pytest.mark.parametrize("route", ["func_grad_of_grad", "jacrev_of_grad",
                                   "create_graph"])
def test_second_derivative_through_attention_raises(route):
    """B5's backward has no backward of its own: a second derivative through
    ``ops.attention`` raises a RuntimeError naming ROADMAP (JAX would give
    attention's curvature; a zero one must not pass silently), while the
    first derivative, with or without a graph of it, stays the plain
    version's."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 11, 48)).astype(np.float32))
    first = grad(_attn_loss)(w, x)
    if route == "create_graph":
        wg = w.clone().requires_grad_()
        (g,) = torch.autograd.grad(_attn_loss(wg, x), wg, create_graph=True)
        torch.testing.assert_close(g.detach(), first, rtol=0, atol=0)
        second = lambda: torch.autograd.grad(g.sum(), wg)  # noqa: E731
    elif route == "jacrev_of_grad":
        second = lambda: torch.func.jacrev(grad(_attn_loss))(w, x)  # noqa
    else:
        second = lambda: grad(  # noqa: E731
            lambda w: grad(_attn_loss)(w, x).sum())(w)
    with pytest.raises(RuntimeError, match="ROADMAP"):
        second()


@pytest.mark.parametrize("kernel", ["decode_attention"])
def test_kernels_without_backward_refuse_grad_on_the_card(kernel,
                                                          monkeypatch):
    """B6 has no backward (decode is never differentiated): routed as CUDA
    tensors (CPU tensors with the device test patched), inputs that
    require grad raise a RuntimeError naming ROADMAP before any launch."""
    monkeypatch.setattr(ops, "_kernel_device", lambda name, x: True)
    monkeypatch.setattr(ops, "_check_rows_aligned", lambda *args: None)
    monkeypatch.setattr(ops, f"{kernel}_cuda",
                        lambda *args, **kw: pytest.fail("launched"))
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    args = (t(2, 4, 32), t(2, 9, 2, 32), t(2, 9, 2, 32), 6)
    call = ops.attention_decode
    with pytest.raises(RuntimeError, match="ROADMAP"):
        call(args[0].requires_grad_(), *args[1:])
    with pytest.raises(RuntimeError, match="ROADMAP"):
        grad(lambda x: call(x, *args[1:])[0].sum())(args[0].detach())


@pytest.mark.parametrize("route", ["autograd", "func_grad"])
def test_grad_through_mlstm_reaches_the_bwd_kernel(route, monkeypatch):
    """B7 differentiates through its backward kernels: routed as CUDA
    tensors (the device test patched, the launchers pointed at the plain
    versions), grad through ``ops.mlstm`` launches the forward (with its
    chunk states and statistics saved) and the backward once each, the
    backward's dy arrives dense though autograd hands a broadcast one, and
    the gradients equal autograd of the plain version's."""
    seen = []

    def fwd_launcher(q, k, v, i_gate, f_gate, state=None, save=False):
        assert save
        y, final, (cs, ns, ms), stats = mlstm_chunk_fwd_plain(
            q, k, v, i_gate, f_gate, state)
        return ops._mlstm_y(q).copy_(y), final, (cs.to(q.dtype), ns, ms), \
            stats

    def bwd_launcher(*args):
        dy = args[-1]
        seen.append(dy.stride())
        assert dy.is_contiguous() and not ops._broadcast(dy)
        return mlstm_chunk_bwd_plain(*args)

    monkeypatch.setattr(ops, "_kernel_device", lambda name, x: True)
    monkeypatch.setattr(ops, "_check_rows_aligned", lambda *args: None)
    monkeypatch.setattr(ops, "mlstm_chunk_cuda", fwd_launcher)
    monkeypatch.setattr(ops, "mlstm_chunk_bwd_cuda", bwd_launcher)
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (2, 2, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64), (2, 2, 300),
        (2, 2, 300))]
    arrays[1] /= 8.0
    arrays[4] += 2.0
    w = torch.from_numpy(arrays[0][0])   # (H, S, Dh), expanded over B

    def loss(*xs):
        y, _ = ops.mlstm(*xs)
        return (y.sum(0) * w).sum()

    ops.reset_launches()
    xs = [torch.from_numpy(a) for a in arrays]
    if route == "autograd":
        xs = [x.requires_grad_() for x in xs]
        got = torch.autograd.grad(loss(*xs), xs)
    else:
        got = grad(loss, argnums=tuple(range(5)))(*xs)
    assert len(seen) == 1
    assert (ops.LAUNCHES["mlstm_chunk"], ops.LAUNCHES["mlstm_chunk_bwd"]) \
        == (1, 1)
    ps = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _ = mlstm_chunk_plain(*ps)
    want = torch.autograd.grad((y.sum(0) * w).sum(), ps)
    for g, wnt in zip(got, want):
        assert _rel(g.numpy(), wnt.numpy()) <= ATTN_TOL


# ---------------------------------------------------------------------------
# The whole loss.
# ---------------------------------------------------------------------------

FAMILIES = {
    "gemma3": ("gemma3-1b", {}),
    "gemma3_softcap50": ("gemma3-1b", dict(logit_softcap=50.0)),
    "llama4_moe": ("llama4-maverick-400b-a17b", {}),
    "deepseek_mla_moe": ("deepseek-v2-236b", {}),
    "hymba_hybrid": ("hymba-1.5b", {}),
    "qwen2vl_mrope": ("qwen2-vl-7b", {}),
    "seamless_encdec": ("seamless-m4t-large-v2", {}),
    "xlstm_plain": ("xlstm-1.3b", {}),
}
B, S = 2, 16


def _carry(tree, cfg):
    tree = jax.tree.map(np.asarray, tree)
    if cfg.family == "encdec":
        return interop.seq2seq_params_from_arrays(tree, cfg, device="cpu")
    if cfg.family == "ssm":
        return interop.xlstm_params_from_arrays(tree, cfg, device="cpu")
    return interop.causal_lm_params_from_arrays(tree, cfg, device="cpu")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.mrope_sections:
        arrays["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)))
    if cfg.frontend == "vision":
        arrays["frontend_embeds"] = (
            0.1 * rng.standard_normal((B, 4, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frontend_embeds"] = np.zeros((B, S, cfg.d_model), np.float32)
    j_batch = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch = {k: torch.as_tensor(v) for k, v in arrays.items()}
    for key in ("tokens", "labels"):
        batch[key] = batch[key].long()
    return j_batch, batch


def _assert_tree_close(got, want, tol):
    """``got`` a port tree, ``want`` its leaves in ``_named`` order."""
    for (name, g), w in zip(_named(got), want, strict=True):
        g = g.detach().numpy()
        assert g.shape == w.shape, name
        scale = float(np.max(np.abs(w)))
        assert float(np.max(np.abs(g - w))) <= tol * max(scale, 1e-12), (
            name, float(np.max(np.abs(g - w))), scale)


def _named(tree, path=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named(tree[key], f"{path}/{key}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _named(x, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("label", list(FAMILIES))
def test_grad_of_loss_matches_jax(label):
    arch, change = FAMILIES[label]
    j_cfg = dataclasses.replace(j_configs.get_smoke_config(arch), **change)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **change)
    j_model, model = j_registry.build_model(j_cfg), registry.build_model(cfg)
    j_params = j_model.init(jax.random.key(3))
    params = _carry(j_params, cfg)
    j_batch, batch = _batch(cfg)
    j_loss, j_grads = jax.value_and_grad(j_model.loss)(j_params, j_batch)
    grads, loss = grad_and_value(model.loss)(params, batch)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    # the JAX gradient tree in the port's layout, leaf for leaf
    _assert_tree_close(grads, _carry_as_jax_order(j_grads, cfg), GRAD_TOL)


def _carry_as_jax_order(j_tree, cfg):
    """The JAX tree carried into the port's structure, leaves in the
    port's order (the order ``_named`` walks)."""
    carried = _carry(j_tree, cfg)
    return [x.numpy() for _, x in _named(carried)]


def _one_fl_round_matches_jax(arch: str):
    j_cfg = j_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    j_model, model = j_registry.build_model(j_cfg), registry.build_model(cfg)
    j_params = j_model.init(jax.random.key(4))
    params = _carry(j_params, cfg)
    rng = np.random.default_rng(6)
    c, e = 3, 2
    tok = rng.integers(0, cfg.vocab_size, (c, e, B, S + 1)).astype(np.int32)
    arrays = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    weights = np.array([1.0, 0.0, 1.0], np.float32)
    kw = dict(local_steps=e, client_lr=0.5)
    j_new, j_metrics = j_server.make_fl_round_step(j_model.loss, **kw)(
        j_params, {k: jnp.asarray(v) for k, v in arrays.items()},
        jnp.asarray(weights))
    new, metrics = server.make_fl_round_step(model.loss, **kw)(
        params, {k: torch.as_tensor(v).long() for k, v in arrays.items()},
        torch.from_numpy(weights))
    assert float(metrics["loss"]) == pytest.approx(float(j_metrics["loss"]),
                                                   rel=1e-5)
    # compare the round's change of every leaf
    delta = [n - p for (_, n), (_, p) in zip(_named(new), _named(params))]
    j_delta = [a - b for a, b in zip(_carry_as_jax_order(j_new, cfg),
                                     _carry_as_jax_order(j_params, cfg))]
    for d, w in zip(delta, j_delta):
        scale = max(float(np.max(np.abs(w))), 1e-12)
        assert float(np.max(np.abs(d.numpy() - w))) <= 1e-4 * scale


def test_one_fl_round_matches_jax():
    _one_fl_round_matches_jax("gemma3-1b")


def test_one_fl_round_matches_jax_xlstm():
    """The same round of the reduced xlstm-1.3b: vmap over clients of
    grad through B7's autograd.Function (its plain bodies here)."""
    _one_fl_round_matches_jax("xlstm-1.3b")
