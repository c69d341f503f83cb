"""The zoo's new layers against their JAX functions: the MoE dispatch (drops,
tied routers, the combine), MLA (both paths), the selective SSM and its
scan, M-RoPE and partial RoPE, layer norm, the masked cross-entropy, the
soft-capped attention and the int8 KV cache; and, on a card, the
attention kernels' new shapes (B6 at every group 1-8, B5 over unequal
lengths, the soft cap) against their plain versions.

Inputs are drawn with numpy and handed to both packages; parameters are
the JAX ``init_*`` trees carried across as float32 tensors.  Tolerances:
a layer rtol = atol = 1e-5 (a few products apart), the SSM 1e-4 (its scan
sums in another order), the kernels the JAX kernel tests' (2e-5 float32,
2e-2 bfloat16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.models import ssm as j_ssm
from repro.models import transformer as j_transformer
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers, mla, moe, registry, ssm, transformer
from test_torch_zoo import carry

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
SSM_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card (the kernels)")


def _np(x):
    return x.detach().float().cpu().numpy()


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for shape in shapes]


def _tensors(tree):
    """A JAX parameter dict of arrays -> the same of float32 tensors."""
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.as_tensor(np.array(v, np.float32))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------

def _moe_cfg(**kw):
    cfg = dict(n_experts=8, n_experts_per_token=2, capacity_factor=4.0)
    cfg.update(kw)
    return (j_configs.get_smoke_config("deepseek-v2-236b", **cfg),
            configs.get_smoke_config("deepseek-v2-236b", **cfg))


@pytest.mark.parametrize("factor", [0.5, 1.0, 4.0])
def test_apply_moe_matches_jax_with_and_without_drops(factor):
    """Capacity factors 0.5 and 1.0 drop slots (caps of 8 and 16 against
    the busiest expert's share of 48 tokens x 2); 4.0 drops none.  Output
    and aux loss equal JAX's; without drops both equal the dense
    oracle."""
    j_cfg, cfg = _moe_cfg(capacity_factor=factor)
    p = j_moe.init_moe(jax.random.key(0), j_cfg)
    (x,) = _arrays(1, (2, 24, j_cfg.d_model))
    want, j_aux = j_moe.apply_moe(p, jnp.asarray(x), j_cfg)
    got, aux = moe.apply_moe(_tensors(p), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **LAYER_TOL)
    dense = moe.apply_moe_dense_ref(_tensors(p), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(
        _np(dense), np.asarray(j_moe.apply_moe_dense_ref(p, jnp.asarray(x),
                                                         j_cfg)),
        **LAYER_TOL)
    cap = moe._capacity(48, 2, 8, factor)
    assert cap == j_moe._capacity(48, 2, 8, factor)
    dropped = not np.allclose(_np(got), _np(dense), rtol=1e-5, atol=1e-5)
    assert dropped == (factor < 4.0)


def test_tied_router_picks_the_lower_expert_first():
    """A zero router gives every token equal probabilities: top-k takes
    experts 0 .. k-1, as ``jax.lax.top_k`` does."""
    j_cfg, cfg = _moe_cfg(n_experts_per_token=3)
    p = j_moe.init_moe(jax.random.key(2), j_cfg)
    p = {**p, "router": jnp.zeros_like(p["router"])}
    (x,) = _arrays(3, (1, 16, j_cfg.d_model))
    tp = _tensors(p)
    _, gates, ids = moe.route(tp, torch.as_tensor(x).reshape(16, -1), cfg)
    assert ids.tolist() == [[0, 1, 2]] * 16
    np.testing.assert_allclose(_np(gates), 1 / 3, rtol=1e-6)
    vals, idx = moe.top_k(torch.tensor([[0.2, 0.5, 0.5, 0.1, 0.5]]), 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[0.5, 0.5]]
    want, _ = j_moe.apply_moe(p, jnp.asarray(x), j_cfg)
    got, _ = moe.apply_moe(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


def test_moe_combine_is_the_same_every_run():
    j_cfg, cfg = _moe_cfg(capacity_factor=0.5)
    p = _tensors(j_moe.init_moe(jax.random.key(4), j_cfg))
    x = torch.as_tensor(_arrays(5, (2, 24, j_cfg.d_model))[0])
    first, _ = moe.apply_moe(p, x, cfg)
    for _ in range(3):
        assert torch.equal(moe.apply_moe(p, x, cfg)[0], first)


# ---------------------------------------------------------------------------
# MLA.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 4, 5])
def test_apply_mla_both_paths_match_jax(s):
    """No cache (expand path over the sequence), then s new tokens into a
    cache holding 7: the absorbed path at s <= 4, the expand path at 5.
    Output and both cache tensors equal JAX's."""
    j_cfg = j_configs.get_smoke_config("deepseek-v2-236b")
    cfg = configs.get_smoke_config("deepseek-v2-236b")
    p = j_mla.init_mla(jax.random.key(6), j_cfg)
    tp = _tensors(p)
    x0, x1 = _arrays(7, (2, 7, j_cfg.d_model), (2, s, j_cfg.d_model))
    pos0 = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    pos1 = np.broadcast_to(np.arange(7, 7 + s)[None], (2, s)).astype(np.int32)
    want, _, _ = j_mla.apply_mla(p, jnp.asarray(x0), j_cfg, jnp.asarray(pos0))
    got = mla.apply_mla(tp, torch.as_tensor(x0), cfg, torch.as_tensor(pos0))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)

    smax = 16
    j_ckv = jnp.zeros((2, smax, j_cfg.kv_lora_rank))
    j_kr = jnp.zeros((2, smax, j_cfg.rope_head_dim))
    _, j_ckv, j_kr = j_mla.apply_mla(p, jnp.asarray(x0), j_cfg,
                                     jnp.asarray(pos0), cache_ckv=j_ckv,
                                     cache_krope=j_kr, cache_len=0)
    want, j_ckv, j_kr = j_mla.apply_mla(p, jnp.asarray(x1), j_cfg,
                                        jnp.asarray(pos1), cache_ckv=j_ckv,
                                        cache_krope=j_kr, cache_len=7)
    ckv = torch.zeros((2, smax, cfg.kv_lora_rank))
    kr = torch.zeros((2, smax, cfg.rope_head_dim))
    mla.apply_mla(tp, torch.as_tensor(x0), cfg, torch.as_tensor(pos0),
                  cache_ckv=ckv, cache_krope=kr, cache_len=0)
    got = mla.apply_mla(tp, torch.as_tensor(x1), cfg, torch.as_tensor(pos1),
                        cache_ckv=ckv, cache_krope=kr, cache_len=7)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(_np(ckv), np.asarray(j_ckv), **LAYER_TOL)
    np.testing.assert_allclose(_np(kr), np.asarray(j_kr), **LAYER_TOL)


# ---------------------------------------------------------------------------
# The selective SSM.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_ssm_scan_matches_the_naive_recurrence(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 3, 4)).astype(np.float32)
    bx = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    h, want = h0.astype(np.float64), []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    got = ssm._ssm_scan(torch.as_tensor(a), torch.as_tensor(bx),
                        torch.as_tensor(h0))
    np.testing.assert_allclose(_np(got), np.stack(want, 1), **SSM_TOL)
    j_got = j_ssm._ssm_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    np.testing.assert_allclose(_np(got), np.asarray(j_got), **SSM_TOL)


def test_apply_ssm_matches_jax_over_a_sequence_then_a_step():
    """A sequence from zero states, then one step from the states it ends
    in (conv state and ssm state h0): outputs and states equal JAX's."""
    j_cfg = j_configs.get_smoke_config("hymba-1.5b")
    cfg = configs.get_smoke_config("hymba-1.5b")
    d_inner = j_cfg.n_heads * j_cfg.head_dim
    p = j_ssm.init_ssm(jax.random.key(8), j_cfg, d_inner)
    tp = _tensors(p)
    x0, x1 = _arrays(9, (2, 30, j_cfg.d_model), (2, 1, j_cfg.d_model))
    want, j_conv, j_h = j_ssm.apply_ssm(p, jnp.asarray(x0), j_cfg)
    got, conv, h = ssm.apply_ssm(tp, torch.as_tensor(x0), cfg)
    for g, w in ((got, want), (conv, j_conv), (h, j_h)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **SSM_TOL)
    want, j_conv, j_h = j_ssm.apply_ssm(p, jnp.asarray(x1), j_cfg, j_conv,
                                        j_h)
    got, conv, h = ssm.apply_ssm(tp, torch.as_tensor(x1), cfg, conv, h)
    for g, w in ((got, want), (conv, j_conv), (h, j_h)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **SSM_TOL)


def test_init_ssm_draws_dt_bias_in_its_range():
    cfg = configs.get_smoke_config("hymba-1.5b")
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, 128,
                     device="cpu")
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 0.999e-3) & (dt < 1.001e-1)).all())
    assert torch.equal(p["a_log"][0], torch.log(torch.arange(1., 9.)))


# ---------------------------------------------------------------------------
# Positions, norms, losses, attention.
# ---------------------------------------------------------------------------

def test_apply_mrope_matches_jax():
    (x,) = _arrays(10, (2, 9, 3, 32))
    rng = np.random.default_rng(11)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    got = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                             (8, 4, 4), 1_000_000.0)
    want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (8, 4, 4),
                                1_000_000.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    with pytest.raises(ValueError):
        layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos[0]),
                           (8, 4, 4))


def test_apply_partial_rope_matches_jax():
    (x,) = _arrays(12, (2, 9, 3, 48))
    pos = np.arange(3, 12)[None].repeat(2, 0).astype(np.int32)
    got = layers.apply_partial_rope(torch.as_tensor(x), torch.as_tensor(pos),
                                    16)
    want = j_layers.apply_partial_rope(jnp.asarray(x), jnp.asarray(pos), 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    np.testing.assert_array_equal(_np(got)[..., 16:], x[..., 16:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    x, scale, bias = _arrays(13, (3, 5, 64), (64,), (64,))
    got = layers.layer_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                            torch.as_tensor(scale), torch.as_tensor(bias))
    want = j_layers.layer_norm(jnp.asarray(x, getattr(jnp, dtype)),
                               jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == getattr(torch, dtype)
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    (logits,) = _arrays(14, (2, 7, 33), scale=3.0)
    rng = np.random.default_rng(15)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) < 0.6) if masked else None
    got = layers.softmax_cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask))
    want = j_layers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), **LAYER_TOL)
    zero = layers.softmax_cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(labels),
        torch.zeros((2, 7), dtype=torch.bool))
    assert float(zero) == 0.0


@pytest.mark.parametrize("q_len,offset,window", [(12, 0, 0), (12, 0, 5),
                                                 (1, 30, 16)])
def test_soft_capped_attention_matches_jax(q_len, offset, window):
    """The plain attention with logit_softcap = 5 (scores of x 2 inputs
    reach it), chunked too; and the kernels' plain versions (B5 over the
    whole sequence, B6 against a cache) on the same function."""
    q, k, v = _arrays(16, (2, q_len, 4, 32), (2, 32, 2, 32), (2, 32, 2, 32),
                      scale=2.0)
    valid = offset + q_len if offset else None
    j_mask = j_layers.make_attention_mask(q_len, 32, offset, True, window,
                                          valid)
    want = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              j_mask, logit_softcap=5.0)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    mask = layers.make_attention_mask(q_len, 32, offset, True, window, valid)
    np.testing.assert_allclose(
        _np(layers.attention(tq, tk, tv, mask, logit_softcap=5.0)),
        np.asarray(want), **LAYER_TOL)
    got = layers.chunked_attention(tq, tk, tv, window=window, q_offset=offset,
                                   kv_valid_len=valid, logit_softcap=5.0,
                                   chunk_size=5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    if offset:   # one token against the cache's first 31 keys
        lo = valid - window
        got = ops.attention_decode(tq[:, 0], tk[:, lo:valid], tv[:, lo:valid],
                                   window, softcap=5.0)
        np.testing.assert_allclose(_np(got), np.asarray(want)[:, 0],
                                   **LAYER_TOL)
    else:
        got = ops.attention(tq.transpose(1, 2), tk[:, :q_len].transpose(1, 2),
                            tv[:, :q_len].transpose(1, 2), window=window,
                            softcap=5.0).transpose(1, 2)
        j_mask = j_layers.make_attention_mask(q_len, q_len, 0, True, window)
        want = j_layers.attention(jnp.asarray(q), jnp.asarray(k[:, :q_len]),
                                  jnp.asarray(v[:, :q_len]), j_mask,
                                  logit_softcap=5.0)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


def test_flash_plain_takes_keys_of_their_own_length_without_the_mask():
    """Sq 9 against Skv 21, non-causal (cross-attention), equals the JAX
    attention with no mask; the causal mask still needs Sq = Skv."""
    q, k, v = _arrays(17, (2, 4, 9, 32), (2, 2, 21, 32), (2, 2, 21, 32))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=False)
    want = j_layers.attention(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                                for x in (q, k, v)), None)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               **LAYER_TOL)
    with pytest.raises(ValueError, match="causal"):
        ops.attention(tq, tk, tv, causal=True)


# ---------------------------------------------------------------------------
# The int8 KV cache.
# ---------------------------------------------------------------------------

def test_quantize_kv_is_jax_bit_for_bit():
    (x,) = _arrays(18, (2, 11, 3, 32), scale=2.0)
    x[0, 0, 0] = 0.0                                    # the 1e-8 floor
    x[0, 1, 0, :4] = [127.0, 63.5, -63.5, 0.5]          # half to even
    q, s = transformer._quantize_kv(torch.as_tensor(x))
    j_q, j_s = j_transformer._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    back = transformer._dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_transformer._dequantize_kv(j_q, j_s,
                                                              jnp.float32)))


def test_int8_kv_cache_decode_accuracy():
    """``tests/test_model_units.py``'s check on the port: the int8 cache's
    decode logits within 2% of the compute-dtype cache's, and equal to the
    JAX int8 model's."""
    j_cfg = j_configs.get_smoke_config("command-r-35b")
    j_cfg8 = dataclasses.replace(j_cfg, kv_cache_dtype="int8")
    j_params = j_registry.build_model(j_cfg).init(jax.random.key(0))
    cfg = configs.get_smoke_config("command-r-35b")
    m = registry.build_model(cfg)
    m8 = registry.build_model(dataclasses.replace(cfg, kv_cache_dtype="int8"))
    params = carry(j_params, cfg)
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
    new = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
    _, c = m.prefill(params, {"tokens": tok}, max_len=36)
    ld, _ = m.decode_step(params, c, new)
    _, c8 = m8.prefill(params, {"tokens": tok}, max_len=36)
    ld8, c8 = m8.decode_step(params, c8, new)
    assert c8["k"].dtype == torch.int8 and c8["k_scale"].dtype == torch.float32
    rel = float((ld8 - ld).abs().max()) / float(ld.abs().max())
    assert rel < 0.02, rel
    j_m8 = j_registry.build_model(j_cfg8)
    _, j_c8 = j_m8.prefill(j_params, {"tokens": jnp.asarray(tok.numpy())},
                           max_len=36)
    j_ld8, j_c8 = j_m8.decode_step(j_params, j_c8, jnp.asarray(new.numpy()))
    np.testing.assert_allclose(_np(ld8), np.asarray(j_ld8), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(c8["k"][:, :, :33].numpy(),
                                  np.asarray(j_c8["k"])[:, :, :33])


# ---------------------------------------------------------------------------
# The dense features on gemma3-1b's reduced config, model against model.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    dict(family="moe", n_experts=4, n_experts_per_token=2, d_ff_expert=64,
         capacity_factor=4.0),
    dict(family="hybrid", ssm_state=8),
    dict(kv_cache_dtype="int8"), dict(mrope_sections=(8, 4, 4)),
    dict(logit_softcap=30.0), dict(parallel_block=True),
])
def test_model_features_run_and_match_jax(change):
    """Each feature the port once refused, on gemma3-1b's reduced config
    (local/global layers, window 16, post norms): prefill of 24 tokens and
    4 greedy decode steps against the JAX model, within 1e-4."""
    j_cfg = dataclasses.replace(j_configs.get_smoke_config("gemma3-1b"),
                                **change)
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3-1b"), **change)
    j_model = j_registry.build_model(j_cfg)
    j_params = j_model.init(jax.random.key(3))
    model = registry.build_model(cfg)
    params = carry(j_params, cfg)
    toks = np.random.default_rng(4).integers(0, 512, (2, 24)).astype(np.int32)
    j_batch, batch = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.as_tensor(toks).long()}
    if cfg.mrope_sections:
        pos = np.ascontiguousarray(np.broadcast_to(
            np.arange(24, dtype=np.int32)[None, None], (3, 2, 24)))
        j_batch["positions"], batch["positions"] = (jnp.asarray(pos),
                                                    torch.as_tensor(pos))
    j_logits, j_cache = j_model.prefill(j_params, j_batch, max_len=28)
    logits, cache = model.prefill(params, batch, max_len=28)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), rtol=1e-4,
                               atol=1e-4)
    for step in range(24, 28):
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        j_kw, kw = {}, {}
        if cfg.mrope_sections:
            j_kw["positions"] = jnp.full((3, 2, 1), step, jnp.int32)
            kw["positions"] = torch.full((3, 2, 1), step, dtype=torch.int32)
        j_logits, j_cache = j_model.decode_step(
            j_params, j_cache, jnp.asarray(tok.numpy().astype(np.int32)),
            **j_kw)
        logits, cache = model.decode_step(params, cache, tok, **kw)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The attention kernels' new shapes, on a card.
# ---------------------------------------------------------------------------

def _cuda_heads(seed, dtype, *shapes):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in shapes]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [3, 5, 6, 7])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_cuda_decode_attention_at_every_group(dtype, g, d):
    """B6 at the groups 1, 2, 4, 8 leave out: llama4 and hymba decode at
    G = 5, qwen2-vl at 7."""
    q, k, v = _cuda_heads(g, dtype, (4, 2 * g, d), (4, 2080, 2, d),
                          (4, 2080, 2, d))
    for lo, valid in ((0, 2079), (1055, 2079), (0, 1)):
        kw, vw = k[:, lo:valid], v[:, lo:valid]
        torch.testing.assert_close(
            ops.attention_decode(q, kw, vw, valid - lo),
            decode_attention_plain(q, kw, vw, valid - lo), **ATTN_TOL[dtype])


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (4, 16, 16, 2048, 1500, 64, False, 0),   # seamless' cross-attention
    (2, 16, 16, 300, 300, 64, False, 0),     # an encoder's self-attention
    (2, 4, 4, 100, 37, 32, False, 0),        # a short source
    (1, 10, 2, 700, 700, 64, True, 1024),    # G = 5 (hymba), D = 64
    (1, 10, 2, 700, 700, 128, True, 0),      # G = 5 (llama4), D = 128
    (1, 14, 2, 500, 500, 128, True, 0)])     # G = 7 (qwen2-vl)
def test_cuda_flash_attention_new_shapes(dtype, b, hq, hkv, sq, skv, d,
                                         causal, window):
    q, k, v = _cuda_heads(7, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                          (b, hkv, skv, d))
    torch.testing.assert_close(
        ops.attention(q, k, v, causal=causal, window=window),
        flash_attention_plain(q, k, v, causal=causal, window=window),
        **ATTN_TOL[dtype])


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_soft_capped_attention(dtype):
    """gemma3-1b's shapes with c = 50: B5 local and global, B6 against a
    cache."""
    q, k, v = _cuda_heads(8, dtype, (4, 4, 2048, 256), (4, 1, 2048, 256),
                          (4, 1, 2048, 256))
    for window in (1024, 0):
        torch.testing.assert_close(
            ops.attention(q, k, v, window=window, softcap=50.0),
            flash_attention_plain(q, k, v, window=window, softcap=50.0),
            **ATTN_TOL[dtype])
    q1, kc, vc = q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2)
    torch.testing.assert_close(
        ops.attention_decode(q1, kc, vc, 2047, softcap=50.0),
        decode_attention_plain(q1, kc, vc, 2047, softcap=50.0),
        **ATTN_TOL[dtype])
