"""The port's model zoo slice (gemma3-1b's dense ``CausalLM``) against the
JAX package: configs, layers, and the whole model's prefill and decode.

Layer inputs are drawn with numpy and handed to both packages; the model's
parameters are drawn by JAX's ``CausalLM.init`` and carried across by
``interop.causal_lm_params_from_arrays``.  On the CPU the attention
wrappers run the kernels' plain versions.  Tolerances: float32 layers
rtol = atol = 1e-5 (one or two products apart), the whole model 1e-4
(2-4 layers of products and a softmax apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro_torch import configs, interop
from repro_torch.kernels import ops
from repro_torch.models import config, layers, registry, transformer

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "gemma3-1b"


def _np(x):
    return x.detach().float().cpu().numpy()


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _params_from_jax(tree):
    """A JAX parameter dict of arrays -> the same of float32 tensors."""
    return {key: (_params_from_jax(x) if isinstance(x, dict)
                  else torch.as_tensor(np.array(x, np.float32)))
            for key, x in tree.items()}


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

def test_model_config_has_the_jax_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(config.ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(j_config.ModelConfig)}
    assert ours == theirs


@pytest.mark.parametrize("reduced", [False, True])
def test_gemma3_config_matches_jax(reduced):
    get = "get_smoke_config" if reduced else "get_config"
    ours = getattr(configs, get)(ARCH)
    theirs = getattr(j_configs, get)(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.q_per_kv == theirs.q_per_kv
    assert [ours.is_global_layer(i) for i in range(ours.n_layers)] == \
        [theirs.is_global_layer(i) for i in range(theirs.n_layers)]
    assert ours.compute_dtype == (torch.float32 if reduced else torch.bfloat16)
    assert ours.param_count() == theirs.param_count()


def test_full_gemma3_shape():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (26, 1152, 4, 1, 256, 6912, 262_144, 1024)
    assert sum(cfg.is_global_layer(i) for i in range(26)) == 4  # 5:1


def test_reduced_overrides_and_moe_layers_match_jax():
    for ours, theirs in ((config.reduced(configs.get_config(ARCH), n_layers=3),
                          j_config.reduced(j_configs.get_config(ARCH),
                                           n_layers=3)),):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    moe = dataclasses.replace(configs.get_config(ARCH), n_experts=8,
                              moe_every=2, n_dense_leading=1)
    j_moe = dataclasses.replace(j_configs.get_config(ARCH), n_experts=8,
                                moe_every=2, n_dense_leading=1)
    assert [moe.is_moe_layer(i) for i in range(8)] == \
        [j_moe.is_moe_layer(i) for i in range(8)]


def test_other_archs_are_not_yet_ported():
    assert configs.ARCH_NAMES == j_configs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        if name in (ARCH, "xlstm-1.3b"):     # ported
            continue
        with pytest.raises(NotImplementedError, match="not yet ported"):
            configs.get_config(name)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("change", [
    dict(family="moe", n_experts=4), dict(family="hybrid"),
    dict(kv_cache_dtype="int8"), dict(mrope_sections=(8, 4, 4)),
    dict(logit_softcap=30.0), dict(parallel_block=True),
])
def test_unported_model_features_raise(change):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **change)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.build_model(cfg)


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, scale = _arrays(0, (3, 5, 64), (64,))
    got = layers.rms_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                          torch.as_tensor(scale), 1e-6)
    want = j_layers.rms_norm(jnp.asarray(x, getattr(jnp, dtype)),
                             jnp.asarray(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("theta,start", [(10_000.0, 0), (1_000_000.0, 37)])
def test_apply_rope_matches_jax(theta, start):
    (x,) = _arrays(1, (2, 9, 3, 32))
    pos = np.arange(start, start + 9)[None].repeat(2, 0).astype(np.int32)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, True), (True, False)])
def test_project_qkv_matches_jax(qkv_bias, qk_norm):
    p = j_layers.init_attention(jax.random.key(2), 64, 4, 2, 16,
                                qkv_bias=qkv_bias, qk_norm=qk_norm)
    rng = np.random.default_rng(3)
    p = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                             .astype(np.float32) if v.ndim == 1 else 0)
         for k, v in p.items()}          # non-zero biases and norm scales
    (x,) = _arrays(4, (2, 7, 64))
    got = layers.project_qkv(_params_from_jax(p), torch.as_tensor(x), 4, 2,
                             16, torch.float32)
    want = j_layers.project_qkv(p, jnp.asarray(x), 4, 2, 16, jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(kind):
    p = j_layers.init_mlp(jax.random.key(5), 64, 96, kind)
    (x,) = _arrays(6, (2, 7, 64))
    got = layers.apply_mlp(_params_from_jax(p), torch.as_tensor(x), kind,
                           torch.float32)
    want = j_layers.apply_mlp(p, jnp.asarray(x), kind, jnp.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("q_len,offset,window,valid", [
    (12, 0, 0, None), (12, 0, 5, None), (1, 30, 16, 31), (4, 20, 0, 24)])
def test_attention_oracles_match_jax(q_len, offset, window, valid):
    q, k, v = _arrays(7, (2, q_len, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    j_mask = j_layers.make_attention_mask(q_len, 32, offset, True, window,
                                          valid)
    mask = layers.make_attention_mask(q_len, 32, offset, True, window, valid)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    want = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              j_mask)
    np.testing.assert_allclose(_np(layers.attention(tq, tk, tv, mask)),
                               np.asarray(want), **LAYER_TOL)
    got = layers.chunked_attention(tq, tk, tv, window=window, q_offset=offset,
                                   kv_valid_len=valid, chunk_size=5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# The reduced gemma3-1b CausalLM against JAX's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    gemma3-1b (4 layers, window 16, global every 2nd), one parameter set."""
    j_cfg = j_configs.get_smoke_config(ARCH)
    j_model = j_registry.build_model(j_cfg)
    j_params = j_model.init(jax.random.key(0))
    cfg = configs.get_smoke_config(ARCH)
    params = interop.causal_lm_params_from_arrays(
        jax.tree.map(np.asarray, j_params), cfg, device="cpu")
    return j_model, j_params, registry.build_model(cfg), params


def test_interop_carries_every_parameter(reduced_pair):
    j_model, j_params, model, params = reduced_pair
    fresh = model.init(0, device="cpu")
    assert len(params["blocks"]) == len(fresh["blocks"]) == 4
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(j_params)[0]}
    for i, block in enumerate(params["blocks"]):
        assert jax.tree.structure(jax.tree.map(lambda x: 0, fresh["blocks"][i])) \
            == jax.tree.structure(jax.tree.map(lambda x: 0, block))
        np.testing.assert_array_equal(
            block["attn"]["wq"].numpy(), flat["['blocks']['attn']['wq']"][i])
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(j_params["embed"]))


def test_interop_rejects_trees_it_cannot_carry(reduced_pair):
    _, j_params, _, _ = reduced_pair
    tree = jax.tree.map(np.asarray, j_params)
    with pytest.raises(ValueError, match="layers"):
        interop.causal_lm_params_from_arrays(
            tree, dataclasses.replace(configs.get_smoke_config(ARCH),
                                      n_layers=3), device="cpu")
    with pytest.raises(NotImplementedError):
        interop.causal_lm_params_from_arrays({**tree, "pairs": {}},
                                             configs.get_smoke_config(ARCH),
                                             device="cpu")


def test_forward_without_cache_matches_jax(reduced_pair):
    j_model, j_params, model, params = reduced_pair
    toks = np.random.default_rng(8).integers(0, 512, (2, 40)).astype(np.int32)
    want, _, _ = j_model.forward(j_params, jnp.asarray(toks))
    got, cache = model.forward(params, torch.as_tensor(toks))
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("prompt_len", [24, 5])
def test_prefill_and_decode_match_jax(reduced_pair, prompt_len):
    """Prefill (prompt 24 > the window of 16: the window binds in both
    prefill and decode; 5: it binds from the 12th decode position on), then
    8 greedy decode steps: the same tokens, logits within MODEL_TOL."""
    j_model, j_params, model, params = reduced_pair
    gen = 8 if prompt_len > 16 else 14
    toks = np.random.default_rng(9).integers(0, 512, (2, prompt_len))
    toks = toks.astype(np.int32)
    max_len = prompt_len + gen
    j_logits, j_cache = j_model.prefill(j_params, {"tokens": jnp.asarray(toks)},
                                        max_len=max_len)
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                                  max_len=max_len)
    assert logits.shape == (2, 1, 512)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **MODEL_TOL)
    for _ in range(gen):
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1)[:, None]
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
        j_logits, j_cache = j_model.decode_step(j_params, j_cache, j_tok)
        logits, cache = model.decode_step(params, cache, tok)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits),
                                   **MODEL_TOL)
    assert cache["len"] == int(j_cache["len"]) == max_len
    np.testing.assert_allclose(_np(cache["k"]), np.asarray(j_cache["k"]),
                               **MODEL_TOL)
    np.testing.assert_allclose(_np(cache["v"]), np.asarray(j_cache["v"]),
                               **MODEL_TOL)


def test_attention_kernels_get_static_windows_and_the_cache_slice(
        reduced_pair, monkeypatch):
    """Prefill calls the flash-attention wrapper once per layer with the
    layer's window; decode calls the decode wrapper once per layer, with
    the last ``window`` filled positions on a local layer."""
    _, _, model, params = reduced_pair
    calls = []
    flash, decode = ops.attention, ops.attention_decode

    def spy_flash(q, k, v, *, causal, window):
        calls.append(("flash", window, q.shape[2]))
        return flash(q, k, v, causal=causal, window=window)

    def spy_decode(q, k, v, valid_len):
        calls.append(("decode", k.shape[1], valid_len))
        return decode(q, k, v, valid_len)

    monkeypatch.setattr(ops, "attention", spy_flash)
    monkeypatch.setattr(ops, "attention_decode", spy_decode)
    toks = torch.zeros((1, 20), dtype=torch.long)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=22)
    assert calls == [("flash", 16, 20), ("flash", 0, 20)] * 2
    calls.clear()
    model.decode_step(params, cache, toks[:, :1])
    # valid length 21 > window 16: local layers see positions [5, 21)
    assert calls == [("decode", 16, 16), ("decode", 21, 21)] * 2


def test_cast_params_keeps_values_and_norms(reduced_pair):
    _, _, model, params = reduced_pair
    bf = dataclasses.replace(model.cfg, dtype="bfloat16")
    cast = registry.build_model(bf).cast_params(params)
    block = cast["blocks"][0]
    assert block["attn"]["wq"].dtype == torch.bfloat16
    assert block["attn"]["q_norm"].dtype == torch.float32
    assert block["ln1"].dtype == torch.float32 and cast["ln_f"].dtype == torch.float32
    assert torch.equal(cast["embed"], params["embed"].to(torch.bfloat16))
    toks = torch.arange(12)[None] % 512
    lm = registry.build_model(bf)
    a, _ = lm.forward(params, toks)
    b, _ = lm.forward(cast, toks)
    assert torch.equal(a, b)


def test_bf16_prefill_tracks_jax(reduced_pair):
    """In bfloat16 the two models round at different places (the JAX
    attention casts its probabilities to bf16, the port's kernels keep
    them in float32): last logits within 5e-2."""
    j_model, j_params, _, params = reduced_pair
    j_bf = j_registry.build_model(dataclasses.replace(j_model.cfg,
                                                      dtype="bfloat16"))
    bf = registry.build_model(dataclasses.replace(configs.get_smoke_config(ARCH),
                                                  dtype="bfloat16"))
    toks = np.random.default_rng(10).integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = j_bf.prefill(j_params, {"tokens": jnp.asarray(toks)}, max_len=30)
    got, cache = bf.prefill(params, {"tokens": torch.as_tensor(toks)},
                            max_len=30)
    assert got.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_model_path_on_cpu_launches_no_kernel(reduced_pair):
    _, _, model, params = reduced_pair
    ops.reset_launches()
    logits, cache = model.prefill(params, {"tokens": torch.ones((1, 3),
                                                                dtype=torch.long)},
                                  max_len=5)
    model.decode_step(params, cache, torch.ones((1, 1), dtype=torch.long))
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


def test_cache_overflow_and_multi_token_append_raise(reduced_pair):
    _, _, model, params = reduced_pair
    toks = torch.ones((1, 4), dtype=torch.long)
    _, cache = model.prefill(params, {"tokens": toks}, max_len=6)
    with pytest.raises(ValueError, match="cache"):
        model.forward(params, toks, cache=cache)
    with pytest.raises(NotImplementedError):
        model.forward(params, toks[:, :2], cache=cache)


def test_causal_lm_rejects_what_the_registry_rejects():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), n_experts=2)
    with pytest.raises(NotImplementedError):
        transformer.CausalLM(cfg)
