"""The port's xLSTM slice (xlstm-1.3b's ``XLSTMLM``) against the JAX
package: the config, the recurrent cells of ``models/ssm.py``, parameter
interop, and the whole model's no-cache forward, prefill and decode.

Cell inputs are drawn with numpy and handed to both packages; the model's
parameters are drawn by JAX's ``XLSTMLM.init`` and carried across by
``interop.xlstm_params_from_arrays``.  On the CPU ``ops.mlstm`` runs the
kernel's plain version (``ssm.mlstm_chunkwise``).  Tolerances: float32
cells rtol = atol = 1e-5 (a few products apart; the chunkwise form 2e-5,
its state sums a chunk of outer products), the whole model 1e-4 (4
blocks of products apart), as in ``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import registry as j_registry
from repro.models import ssm as j_ssm
from repro_torch import configs, interop
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import registry, ssm, transformer, xlstm

CELL_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


def _np(x):
    return x.detach().float().cpu().numpy()


def _arrays(seed, *shapes, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale + shift).astype(np.float32)
            for shape in shapes]


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _mlstm_inputs(seed, b, h, s, dh):
    """The JAX kernel test's recipe: k / sqrt(Dh), i ~ N(0, 0.5),
    f ~ N(2, 0.5)."""
    q, k, v = _arrays(seed, (b, h, s, dh), (b, h, s, dh), (b, h, s, dh))
    ig, = _arrays(seed + 1, (b, h, s), scale=0.5)
    fg, = _arrays(seed + 2, (b, h, s), scale=0.5, shift=2.0)
    return q, k / np.float32(np.sqrt(dh)), v, ig, fg


def _state(seed, b, h, dh):
    """A non-trivial (C, n, m) to start from."""
    c, n = _arrays(seed, (b, h, dh, dh), (b, h, dh), scale=0.3)
    m, = _arrays(seed + 1, (b, h), scale=0.5)
    return c, n, m


# ---------------------------------------------------------------------------
# Config.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_xlstm_config_matches_jax(reduced):
    get = "get_smoke_config" if reduced else "get_config"
    ours = getattr(configs, get)(ARCH)
    theirs = getattr(j_configs, get)(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.compute_dtype == (torch.float32 if reduced else torch.bfloat16)
    model = registry.build_model(ours)
    assert isinstance(model, xlstm.XLSTMLM)
    assert model._layout == j_registry.build_model(theirs)._layout


def test_full_xlstm_shape_and_param_count():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size,
            cfg.ssm_expand, cfg.slstm_every) == (48, 2048, 4, 50_304, 2, 8)
    model = registry.build_model(cfg)
    assert model._layout == (6, 7)                     # 7 mLSTM + 1 sLSTM
    meta = model.init(0, device="meta")
    assert meta["m_blocks"][0][0]["cell"]["w_qkv"].shape == (4, 1024, 3072)
    assert meta["s_blocks"][0]["cell"]["r_zifo"].shape == (4, 512, 2048)
    assert cfg.param_count() == 1_918_020_944
    assert cfg.param_count() == j_configs.get_config(ARCH).param_count()


def test_model_classes_reject_each_others_family():
    with pytest.raises(ValueError, match="ssm"):
        transformer.CausalLM(configs.get_smoke_config(ARCH))
    with pytest.raises(ValueError, match="ssm family"):
        xlstm.XLSTMLM(configs.get_smoke_config("gemma3-1b"))
    bad = dataclasses.replace(configs.get_smoke_config(ARCH), n_layers=3)
    with pytest.raises(ValueError, match="super-blocks"):
        registry.build_model(bad).init(0, device="meta")


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_jax(with_state):
    x, w, st = _arrays(0, (2, 7, 48), (4, 48), (2, 3, 48))
    state = st if with_state else None
    got, got_state = ssm.causal_depthwise_conv(
        *_t(x, w), None if state is None else torch.as_tensor(state))
    want, want_state = j_ssm.causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    _close(got, want, CELL_TOL)
    _close(got_state, want_state, CELL_TOL)


def test_mlstm_step_matches_jax():
    q, k, v, ig, fg = _mlstm_inputs(1, 2, 3, 1, 32)
    c, n, m = _state(3, 2, 3, 32)
    args = [x[:, :, 0] for x in (q, k, v, ig, fg)] + [c, n, m]
    got = ssm.mlstm_step(*_t(*args))
    want = j_ssm.mlstm_step(*(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        _close(g, w, CELL_TOL)


@pytest.mark.parametrize("s,chunk,with_state", [
    (64, 16, False), (64, 64, True), (96, 32, True)])
def test_mlstm_chunkwise_matches_jax(s, chunk, with_state):
    q, k, v, ig, fg = _mlstm_inputs(4, 2, 2, s, 32)
    state = _state(6, 2, 2, 32) if with_state else None
    got_y, got_state = ssm.mlstm_chunkwise(
        *_t(q, k, v, ig, fg), None if state is None else tuple(_t(*state)),
        chunk=chunk)
    want_y, want_state = j_ssm.mlstm_chunkwise(
        *(jnp.asarray(x) for x in (q, k, v, ig, fg)),
        None if state is None else tuple(jnp.asarray(x) for x in state),
        chunk=chunk)
    _close(got_y, want_y, CHUNK_TOL)
    for g, w in zip(got_state, want_state):
        _close(g, w, CHUNK_TOL)


def test_mlstm_chunkwise_rejects_a_chunk_that_does_not_divide():
    q, k, v, ig, fg = _t(*_mlstm_inputs(7, 1, 1, 10, 32))
    with pytest.raises(ValueError, match="divide"):
        ssm.mlstm_chunkwise(q, k, v, ig, fg, chunk=4)


def test_mlstm_parallel_matches_jax_and_the_chunkwise_form():
    q, k, v, ig, fg = _mlstm_inputs(8, 2, 2, 48, 32)
    got = ssm.mlstm_parallel(*_t(q, k, v, ig, fg))
    want = j_ssm.mlstm_parallel(*(jnp.asarray(x) for x in (q, k, v, ig, fg)))
    for g, w in zip(got, want):
        _close(g, w, CELL_TOL)
    chunked, _ = ssm.mlstm_chunkwise(*_t(q, k, v, ig, fg), chunk=16)
    np.testing.assert_allclose(_np(chunked), _np(got[0]), **CHUNK_TOL)


def test_slstm_step_matches_jax():
    cfg = configs.get_smoke_config(ARCH)
    p = j_ssm.init_slstm(jax.random.key(0), cfg, cfg.d_model)
    rng = np.random.default_rng(9)
    p = {key: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
        np.float32) for key, x in p.items()}    # non-zero bias
    dh = cfg.d_model // cfg.n_heads
    xt, c, n, h = _arrays(10, (2, 4 * cfg.d_model), *[(2, 4, dh)] * 3)
    m, = _arrays(11, (2, 4, dh), scale=0.5)
    got = ssm.slstm_step({key: torch.as_tensor(x) for key, x in p.items()},
                         torch.as_tensor(xt), tuple(_t(c, n, h, m)), cfg,
                         cfg.d_model)
    want = j_ssm.slstm_step(p, jnp.asarray(xt),
                            tuple(jnp.asarray(x) for x in (c, n, h, m)), cfg,
                            cfg.d_model)
    for g, w in zip(got, want):
        _close(g, w, CELL_TOL)


# ---------------------------------------------------------------------------
# The reduced xlstm-1.3b against JAX's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    xlstm-1.3b (4 blocks: 2 super-blocks of 1 mLSTM + 1 sLSTM, d_model 128,
    mLSTM heads of 64), one parameter set."""
    j_cfg = j_configs.get_smoke_config(ARCH)
    j_model = j_registry.build_model(j_cfg)
    j_params = j_model.init(jax.random.key(0))
    cfg = configs.get_smoke_config(ARCH)
    params = interop.xlstm_params_from_arrays(
        jax.tree.map(np.asarray, j_params), cfg, device="cpu")
    return j_model, j_params, registry.build_model(cfg), params


def test_interop_carries_every_parameter(reduced_pair):
    j_model, j_params, model, params = reduced_pair
    fresh = model.init(0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, fresh)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, params))
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(j_params)[0]}
    count = 0
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        group = keys[0]
        if group == "m_blocks":
            name = "".join(f"['{k}']" for k in keys[3:])
            want = flat[f"['m_blocks']{name}"][keys[1], keys[2]]
        elif group == "s_blocks":
            name = "".join(f"['{k}']" for k in keys[2:])
            want = flat[f"['s_blocks']{name}"][keys[1]]
        else:
            want = flat[f"['{group}']"]
        np.testing.assert_array_equal(x.numpy(), want)
        count += 1
    assert count == sum(
        int(np.prod(x.shape[:2])) if key.startswith("['m_blocks']")
        else x.shape[0] if key.startswith("['s_blocks']") else 1
        for key, x in flat.items())
    assert sum(x.numel() for x in jax.tree.leaves(params)) == \
        model.cfg.param_count()


def test_interop_rejects_trees_it_cannot_carry(reduced_pair):
    _, j_params, _, _ = reduced_pair
    tree = jax.tree.map(np.asarray, j_params)
    with pytest.raises(ValueError, match="mLSTM blocks"):
        interop.xlstm_params_from_arrays(
            tree, dataclasses.replace(configs.get_smoke_config(ARCH),
                                      n_layers=6, slstm_every=3),
            device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        interop.xlstm_params_from_arrays({**tree, "blocks": {}},
                                         configs.get_smoke_config(ARCH),
                                         device="cpu")


@pytest.mark.parametrize("seq", [40, 256])
def test_forward_without_cache_matches_jax(reduced_pair, seq):
    """40 tokens: one chunk of 40 in the plain version; 256: one of 256."""
    j_model, j_params, model, params = reduced_pair
    toks = np.random.default_rng(12).integers(0, 512, (2, seq)).astype(np.int32)
    want, _, _ = j_model.forward(j_params, jnp.asarray(toks))
    got, cache = model.forward(params, torch.as_tensor(toks))
    assert cache is None and got.shape == (2, seq, 512)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("prompt_len", [24, 1])
def test_prefill_and_decode_match_jax(reduced_pair, prompt_len):
    """Prefill (24 tokens through the chunkwise path; 1 through the step),
    then 8 greedy decode steps: the same tokens, logits within MODEL_TOL,
    and the same recurrent cache."""
    j_model, j_params, model, params = reduced_pair
    gen = 8
    toks = np.random.default_rng(13).integers(0, 512, (2, prompt_len))
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
    assert set(cache) == set(j_cache)
    for key in cache:
        if key != "len":
            assert cache[key].shape == j_cache[key].shape, key
            assert cache[key].dtype == getattr(torch, str(j_cache[key].dtype))
            np.testing.assert_allclose(_np(cache[key]), np.asarray(j_cache[key]),
                                       **MODEL_TOL)


def test_prefill_runs_the_chunk_kernel_wrapper_once_per_mlstm_layer(
        reduced_pair, monkeypatch):
    """Prefill hands every mLSTM layer's whole prompt to ``ops.mlstm``, with
    the cache's state as the initial state; a decode step does not call
    it."""
    _, _, model, params = reduced_pair
    calls = []
    wrapped = ops.mlstm

    def spy(q, k, v, i_gate, f_gate, state=None):
        calls.append((tuple(q.shape), state is not None))
        return wrapped(q, k, v, i_gate, f_gate, state)

    monkeypatch.setattr(ops, "mlstm", spy)
    toks = torch.zeros((1, 20), dtype=torch.long)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=21)
    assert calls == [((1, 4, 20, 64), True)] * 2
    calls.clear()
    model.decode_step(params, cache, toks[:, :1])
    model.forward(params, toks)
    assert calls == [((1, 4, 20, 64), False)] * 2


def test_cast_params_keeps_values_and_norms(reduced_pair):
    _, _, model, params = reduced_pair
    bf = registry.build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    cast = bf.cast_params(params)
    block, sblock = cast["m_blocks"][0][0], cast["s_blocks"][0]
    assert block["cell"]["w_qkv"].dtype == torch.bfloat16
    assert block["cell"]["if_bias"].dtype == torch.bfloat16
    assert sblock["cell"]["r_zifo"].dtype == torch.bfloat16
    assert sblock["ffn"]["w_gate"].dtype == torch.bfloat16
    for norm in (block["ln"], block["cell"]["o_norm"], sblock["ln_ffn"],
                 cast["ln_f"]):
        assert norm.dtype == torch.float32
    toks = torch.arange(12)[None] % 512
    a, _ = bf.forward(params, toks)
    b, _ = bf.forward(cast, toks)
    assert torch.equal(a, b)


def test_bf16_prefill_tracks_jax(reduced_pair):
    """In bfloat16 the two packages round at different places; last logits
    within 5e-2."""
    j_model, j_params, _, params = reduced_pair
    j_bf = j_registry.build_model(dataclasses.replace(j_model.cfg,
                                                      dtype="bfloat16"))
    bf = registry.build_model(dataclasses.replace(configs.get_smoke_config(ARCH),
                                                  dtype="bfloat16"))
    toks = np.random.default_rng(14).integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = j_bf.prefill(j_params, {"tokens": jnp.asarray(toks)}, max_len=30)
    got, cache = bf.prefill(params, {"tokens": torch.as_tensor(toks)},
                            max_len=30)
    assert got.dtype == torch.bfloat16 and cache["m_conv"].dtype == torch.bfloat16
    assert cache["m_C"].dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_model_path_on_cpu_launches_no_kernel(reduced_pair):
    _, _, model, params = reduced_pair
    ops.reset_launches()
    toks = torch.ones((1, 5), dtype=torch.long)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=7)
    model.decode_step(params, cache, toks[:, :1])
    model.forward(params, toks)
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


def test_serve_main_serves_reduced_xlstm_on_cpu(capsys):
    """Prompt 20, 6 greedy tokens: tokens in the vocabulary, the cache's
    length prompt + gen - 1, finite logits, no kernel launched."""
    ops.reset_launches()
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len",
            "20", "--gen", "6", "--temperature", "0"]
    res = serve.main(argv)
    tokens, info = res["tokens"], res["info"]
    assert isinstance(res["model"], xlstm.XLSTMLM)
    assert tokens.shape == (2, 6) and tokens.dtype == torch.long
    assert bool(((tokens >= 0) & (tokens < res["config"].vocab_size)).all())
    assert info["cache"]["len"] == 25 and info["decode_steps"] == 5
    assert bool(torch.isfinite(info["logits"]).all())
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}
    out = capsys.readouterr().out
    assert "[prefill] 2x20" in out and "[cache]  len=25" in out
    assert torch.equal(serve.main(argv)["tokens"], tokens)
