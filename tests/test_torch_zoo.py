"""The rest of the model zoo in the port (MoE, MLA-MoE, hybrid SSM, enc-dec
and the dense features: gemma-2b/7b, command-r's parallel block, qwen2-vl's
M-RoPE and vision stub) against the JAX package: configs, registry, the
whole models' loss, prefill and decode.

Each arch runs its reduced config in float32, the JAX ``init`` tree carried
across by ``interop``; inputs are drawn with numpy and handed to both.  On
the CPU the attention wrappers run the kernels' plain versions.
Tolerances: the whole model rtol = atol = 1e-4 (a few layers of products
and softmaxes apart, as ``test_torch_models.py``); the port's cached decode
against its own uncached forward 5e-5 (``tests/test_arch_smoke.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import registry as j_registry
from repro_torch import configs, interop
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import registry, transformer
from repro_torch.models.encdec import Seq2SeqLM

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLE_ATOL = 5e-5
NEW_ARCHS = ["gemma-2b", "gemma-7b", "command-r-35b", "qwen2-vl-7b",
             "seamless-m4t-large-v2", "llama4-maverick-400b-a17b",
             "deepseek-v2-236b", "hymba-1.5b"]
B, S = 2, 32


def _np(x):
    return x.detach().float().cpu().numpy()


def carry(j_params, cfg):
    """A JAX init tree -> the port's float32 parameters on the CPU."""
    tree = jax.tree.map(np.asarray, j_params)
    if cfg.family == "encdec":
        return interop.seq2seq_params_from_arrays(tree, cfg, device="cpu")
    return interop.causal_lm_params_from_arrays(tree, cfg, device="cpu")


def batches(cfg, seed=0, b=B, s=S, src=None):
    """(JAX batch, port batch) of one numpy draw: tokens and labels, (3, B,
    S) positions for M-RoPE, the vision stub's 8 patch embeddings, the
    audio stub's ``src`` (default S) frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    arrays = {"tokens": tok, "labels": tok}
    if cfg.mrope_sections:
        arrays["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)))
    if cfg.frontend == "vision":
        arrays["frontend_embeds"] = (
            0.1 * rng.standard_normal((b, 8, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        arrays["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, src or s, cfg.d_model))).astype(np.float32)
    j_batch = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch = {k: torch.as_tensor(v) for k, v in arrays.items()}
    for key in ("tokens", "labels"):
        batch[key] = batch[key].long()
    return j_batch, batch


def _no_labels(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params) of one reduced
    arch, one parameter set."""
    name = request.param
    j_cfg = j_configs.get_smoke_config(name)
    j_model = j_registry.build_model(j_cfg)
    j_params = j_model.init(jax.random.key(1))
    cfg = configs.get_smoke_config(name)
    return j_model, j_params, registry.build_model(cfg), carry(j_params, cfg)


# ---------------------------------------------------------------------------
# Configs and the registry.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", j_configs.ARCH_NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_field_for_field(name, reduced):
    get = "get_smoke_config" if reduced else "get_config"
    ours, theirs = getattr(configs, get)(name), getattr(j_configs, get)(name)
    assert configs.ARCH_NAMES == j_configs.ARCH_NAMES
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    n = ours.n_layers
    assert [ours.is_global_layer(i) for i in range(n)] == \
        [theirs.is_global_layer(i) for i in range(n)]
    assert [ours.is_moe_layer(i) for i in range(n)] == \
        [theirs.is_moe_layer(i) for i in range(n)]


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", j_configs.ARCH_NAMES)
def test_full_param_counts_match_jax(name):
    """Both counts from shapes alone (the meta device here, eval_shape
    there); MoE counts routed experts at k/E as JAX does."""
    ours, theirs = configs.get_config(name), j_configs.get_config(name)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()


@pytest.mark.parametrize("name", j_configs.ARCH_NAMES)
def test_build_model_builds_every_arch(name):
    model = registry.build_model(configs.get_config(name))
    j_model = j_registry.build_model(j_configs.get_config(name))
    assert type(model).__name__ == type(j_model).__name__
    spec = registry.param_specs(configs.get_config(name))
    want = j_registry.param_specs(j_configs.get_config(name))
    assert sum(x.numel() for _, x in _leaves(spec)) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, x in tree.items():
            yield from _leaves(x, (*path, key))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaves(x, (*path, i))
    else:
        yield path, tree


_DTYPES = {"int32": torch.int32, "int8": torch.int8, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("shape_name", list(j_registry.SHAPES))
@pytest.mark.parametrize("name", j_configs.ARCH_NAMES)
def test_input_specs_match_jax(name, shape_name):
    """Every (arch, shape) cell: the same support, and stand-ins of JAX's
    shapes and dtypes (a decode cache key by key; its "len" is the port's
    host int)."""
    cfg, j_cfg = configs.get_config(name), j_configs.get_config(name)
    assert registry.SHAPES == j_registry.SHAPES
    assert registry.supports(cfg, shape_name) == \
        j_registry.supports(j_cfg, shape_name)
    if not registry.supports(cfg, shape_name):
        return
    ours = registry.input_specs(cfg, shape_name)
    theirs = j_registry.input_specs(j_cfg, shape_name)
    flat = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(theirs)[0]}
    mine = {"".join(f"[{k!r}]" for k in path): x
            for path, x in _leaves(ours)}
    assert set(mine) == set(flat)
    for key, spec in flat.items():
        if key.endswith("['len']"):
            assert mine[key] == 0
            continue
        got = mine[key]
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(spec.shape), key
        assert got.dtype == _DTYPES[str(spec.dtype)], key


def test_long_500k_set():
    eligible = {n for n in configs.ARCH_NAMES
                if registry.supports(configs.get_config(n), "long_500k")}
    assert eligible == {"gemma3-1b", "hymba-1.5b", "xlstm-1.3b"}
    assert registry.N_VISION_PATCHES == j_registry.N_VISION_PATCHES == 256
    assert all(registry.is_subquadratic(configs.get_config(n)) ==
               j_registry.is_subquadratic(j_configs.get_config(n))
               for n in configs.ARCH_NAMES)


# ---------------------------------------------------------------------------
# The reduced models against JAX.
# ---------------------------------------------------------------------------

def test_no_cache_logits_and_loss_match_jax(pair):
    """The loss on labelled inputs (every family) and, for the decoder-only
    ones, the logits of an uncached forward at every position."""
    j_model, j_params, model, params = pair
    j_batch, batch = batches(model.cfg)
    np.testing.assert_allclose(float(model.loss(params, batch)),
                               float(j_model.loss(j_params, j_batch)),
                               **MODEL_TOL)
    if isinstance(model, Seq2SeqLM):
        with pytest.raises(NotImplementedError):
            model.forward(params, batch["tokens"])
        return
    kw = {"positions": batch.get("positions"),
          "embeds_override": batch.get("frontend_embeds")}
    j_kw = {"positions": j_batch.get("positions"),
            "embeds_override": j_batch.get("frontend_embeds")}
    want, _, j_aux = j_model.forward(j_params, j_batch["tokens"], **j_kw)
    got, cache, aux = model.forward_aux(params, batch["tokens"], **kw)
    assert cache is None and got.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **MODEL_TOL)


def _decode_positions(cfg, step):
    """(JAX, port) positions of one decode token at ``step`` (M-RoPE only)."""
    if not cfg.mrope_sections:
        return {}, {}
    return ({"positions": jnp.full((3, B, 1), step, jnp.int32)},
            {"positions": torch.full((3, B, 1), step, dtype=torch.int32)})


def test_prefill_then_decode_match_jax(pair):
    """Prefill, then 3 greedy decode steps: the same tokens, logits within
    MODEL_TOL, the cache length the JAX one."""
    j_model, j_params, model, params = pair
    j_batch, batch = batches(model.cfg, seed=1)
    max_len = S + 4
    j_logits, j_cache = j_model.prefill(j_params, _no_labels(j_batch),
                                        max_len=max_len)
    logits, cache = model.prefill(params, _no_labels(batch), max_len=max_len)
    assert logits.shape == (B, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **MODEL_TOL)
    for step in range(S, S + 3):
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1)[:, None]
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
        j_pos, pos = _decode_positions(model.cfg, step)
        j_logits, j_cache = j_model.decode_step(j_params, j_cache, j_tok,
                                                **j_pos)
        logits, cache = model.decode_step(params, cache, tok, **pos)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits),
                                   **MODEL_TOL)
    assert cache["len"] == int(j_cache["len"]) == S + 3
    for key, val in j_cache.items():
        if key != "len":
            np.testing.assert_allclose(_np(cache[key]), np.asarray(
                val, np.float32), **MODEL_TOL, err_msg=key)


def test_cached_decode_matches_own_uncached_forward(pair):
    """``tests/test_arch_smoke.py``'s oracle on the port alone: one token
    decoded after a prefill against the uncached run of the whole sequence
    (the enc-dec: against a prefill of it)."""
    _, _, model, params = pair
    cfg = model.cfg
    _, batch = batches(cfg, seed=2)
    new = torch.randint(0, cfg.vocab_size, (B, 1),
                        generator=torch.Generator().manual_seed(3))
    pre = _no_labels(batch)
    _, cache = model.prefill(params, pre, max_len=S + 4)
    _, pos = _decode_positions(cfg, S)
    got, cache = model.decode_step(params, cache, new, **pos)
    assert cache["len"] == S + 1
    full = torch.cat([batch["tokens"], new], dim=1)
    if isinstance(model, Seq2SeqLM):
        want, _ = model.prefill(params, {**pre, "tokens": full},
                                max_len=S + 4)
        want = want[:, -1]
    else:
        kw = {"embeds_override": batch.get("frontend_embeds")}
        if cfg.mrope_sections:
            kw["positions"] = torch.arange(S + 1, dtype=torch.int32)[
                None, None].expand(3, B, S + 1)
        want = model.forward(params, full, **kw)[0][:, -1]
    assert float((got[:, 0] - want).abs().max()) < ORACLE_ATOL


def test_init_in_the_compute_dtype_equals_cast_params(pair):
    """``init(dtype=...)`` casts each matrix as it is drawn: bit for bit the
    float32 init cast afterwards, leaf for leaf."""
    _, _, model, _ = pair
    bf = registry.build_model(dataclasses.replace(model.cfg,
                                                  dtype="bfloat16"))
    direct = bf.init(5, device="cpu", dtype=torch.bfloat16)
    cast = bf.cast_params(bf.init(5, device="cpu"))
    a, b = dict(_leaves(direct)), dict(_leaves(cast))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    assert any(x.dtype == torch.float32 for x in a.values())   # norm scales


@pytest.mark.parametrize("name", ["gemma3-1b", "xlstm-1.3b"])
def test_init_in_the_compute_dtype_of_the_earlier_archs(name):
    """The same for the two archs of earlier slices (``XLSTMLM`` casts a
    block as it is drawn)."""
    bf = registry.build_model(configs.get_smoke_config(name,
                                                       dtype="bfloat16"))
    direct = dict(_leaves(bf.init(6, device="cpu", dtype=torch.bfloat16)))
    cast = dict(_leaves(bf.cast_params(bf.init(6, device="cpu"))))
    assert direct.keys() == cast.keys()
    assert all(direct[k].dtype == cast[k].dtype
               and torch.equal(direct[k], cast[k]) for k in direct)


def test_model_path_on_cpu_launches_no_kernel(pair):
    _, _, model, params = pair
    _, batch = batches(model.cfg, seed=4)
    ops.reset_launches()
    _, cache = model.prefill(params, _no_labels(batch), max_len=S + 2)
    _, pos = _decode_positions(model.cfg, S)
    model.decode_step(params, cache, batch["tokens"][:, :1], **pos)
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}


def test_seq2seq_with_source_longer_than_target_matches_jax():
    """Source 45 frames, target prompt 13: the cross-attention's Skv differs
    from its Sq at prefill and is the decode kernel's valid_len after."""
    name = "seamless-m4t-large-v2"
    j_model = j_registry.build_model(j_configs.get_smoke_config(name))
    j_params = j_model.init(jax.random.key(4))
    model = registry.build_model(configs.get_smoke_config(name))
    params = carry(j_params, model.cfg)
    j_batch, batch = batches(model.cfg, seed=5, s=13, src=45)
    j_logits, j_cache = j_model.prefill(j_params, _no_labels(j_batch),
                                        max_len=20)
    logits, cache = model.prefill(params, _no_labels(batch), max_len=20)
    assert cache["xk"].shape[2] == 45 and cache["k"].shape[2] == 20
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **MODEL_TOL)
    for _ in range(4):
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        j_logits, j_cache = j_model.decode_step(
            j_params, j_cache, jnp.asarray(tok.numpy().astype(np.int32)))
        logits, cache = model.decode_step(params, cache, tok)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits),
                                   **MODEL_TOL)
    assert cache["len"] == int(j_cache["len"]) == 17


def test_interop_refuses_a_wrong_encdec_tree():
    name = "seamless-m4t-large-v2"
    j_params = j_registry.build_model(j_configs.get_smoke_config(name)).init(
        jax.random.key(0))
    tree = jax.tree.map(np.asarray, j_params)
    cfg = configs.get_smoke_config(name)
    with pytest.raises(ValueError, match="layers"):
        interop.seq2seq_params_from_arrays(
            tree, dataclasses.replace(cfg, n_encoder_layers=1), device="cpu")
    with pytest.raises(ValueError, match="groups"):
        interop.seq2seq_params_from_arrays({**tree, "blocks": {}}, cfg,
                                           device="cpu")


def test_m_rope_without_3d_positions_raises_as_in_jax():
    """The JAX serve passes no positions, so qwen2-vl's M-RoPE meets (B, S)
    ones and raises (ROADMAP C9); the port raises the same way."""
    name = "qwen2-vl-7b"
    j_model = j_registry.build_model(j_configs.get_smoke_config(name))
    j_params = j_model.init(jax.random.key(0))
    model = registry.build_model(configs.get_smoke_config(name))
    params = carry(j_params, model.cfg)
    toks = np.zeros((1, 6), np.int32)
    with pytest.raises(ValueError):
        j_model.forward(j_params, jnp.asarray(toks))
    with pytest.raises(ValueError, match="M-RoPE"):
        model.forward(params, torch.as_tensor(toks).long())


def test_generate_serves_m_rope_with_decode_positions_as_jax():
    """``serve.generate`` with the prompt's (3, B, S) positions in the batch
    and each step's through ``decode_kw``: the greedy tokens and the last
    logits of JAX's prefill and decode steps at the same positions."""
    name, gen = "qwen2-vl-7b", 4
    j_model = j_registry.build_model(j_configs.get_smoke_config(name))
    j_params = j_model.init(jax.random.key(6))
    model = registry.build_model(configs.get_smoke_config(name))
    params = carry(j_params, model.cfg)
    j_batch, batch = batches(model.cfg, seed=7)
    seen = []

    def decode_kw(pos):
        seen.append(pos)
        return _decode_positions(model.cfg, pos)[1]

    tokens, info = serve.generate(
        model, params, _no_labels(batch), max_len=S + gen, gen=gen,
        temperature=0.0, generator=torch.Generator(), decode_kw=decode_kw)
    assert seen == list(range(S, S + gen - 1))
    j_logits, j_cache = j_model.prefill(j_params, _no_labels(j_batch),
                                        max_len=S + gen)
    j_tokens = []
    for step in range(S, S + gen):
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1)[:, None]
        j_tokens.append(np.asarray(j_tok))
        if step < S + gen - 1:
            j_logits, j_cache = j_model.decode_step(
                j_params, j_cache, j_tok,
                **_decode_positions(model.cfg, step)[0])
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.concatenate(j_tokens, axis=1))
    np.testing.assert_allclose(_np(info["logits"]), np.asarray(j_logits),
                               **MODEL_TOL)
    assert info["cache"]["len"] == int(j_cache["len"]) == S + gen - 1


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "hymba-1.5b"])
def test_serve_main_runs_each_family_on_cpu(name, capsys):
    """The serve driver end to end on a reduced config: greedy tokens in
    the vocabulary, the cache filled to prompt + gen - 1, no kernel."""
    ops.reset_launches()
    res = serve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4", "--temperature",
                      "0"])
    tokens, info = res["tokens"], res["info"]
    assert tokens.shape == (2, 4)
    assert bool(((tokens >= 0) & (tokens < res["config"].vocab_size)).all())
    assert info["cache"]["len"] == 23
    assert bool(torch.isfinite(info["logits"]).all())
    assert ops.LAUNCHES == {n: 0 for n in ops.KERNEL_NAMES}
    if res["config"].family == "encdec":
        assert res["batch"]["frontend_embeds"].shape == (2, 20, 128)
    assert "[cache]  len=23" in capsys.readouterr().out


def test_causal_lm_refuses_the_other_families():
    for name in ("xlstm-1.3b", "seamless-m4t-large-v2"):
        with pytest.raises(ValueError, match="family"):
            transformer.CausalLM(configs.get_smoke_config(name))
    with pytest.raises(ValueError, match="even"):
        transformer.CausalLM(configs.get_smoke_config(
            "llama4-maverick-400b-a17b", n_layers=3))
