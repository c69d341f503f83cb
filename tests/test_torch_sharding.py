"""The port's sharding rules and mesh context against the JAX package's.

No ranks and no devices: the port's trees are built on the ``meta`` device
(``registry.param_specs``, ``input_specs``), the JAX package's by
``jax.eval_shape``, both at full size, and the rules only read names,
shapes and the production meshes' axis sizes (16 x 16 and 2 x 16 x 16;
``launch.mesh.Mesh`` beside JAX's abstract mesh).  For every arch, both
meshes, ``serve_2d`` False / True and ``fsdp`` None / True / False, every
port parameter's spec equals JAX's with the stacked layer dims dropped
(the port keeps per-layer lists; JAX never puts an axis on a stacked dim,
which is asserted), and every batch and cache spec of every supported
cell equals JAX's.  Then the mirrors of ``tests/test_sharding_matrix.py``
and ``tests/test_distributed.py``'s rule tests, and ``constraint_spec``
against JAX's ``constrain`` at the shapes of the models' call sites.
"""
import functools
import math
import re

import jax
import pytest

from repro import configs as j_configs
from repro.compat import AxisType, abstract_mesh
from repro.distributed import api as j_api
from repro.distributed import sharding as j_sharding
from repro.models import registry as j_registry
from repro_torch import configs
from repro_torch.distributed import api, sharding, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe, registry

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(which):
    sizes, names = MESHES[which]
    return (abstract_mesh(sizes, names, axis_types=(AxisType.Auto,)
                          * len(names)), Mesh(names, sizes))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(port tree on meta, JAX tree of ShapeDtypeStructs) at full size."""
    return (registry.param_specs(configs.get_config(arch)),
            j_registry.param_specs(j_configs.get_config(arch)))


def _jax_specs(tree_sh) -> dict:
    """keystr -> the spec tuple of a JAX NamedSharding tree."""
    return {jax.tree_util.keystr(path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                tree_sh, is_leaf=lambda v: hasattr(v, "spec"))}


def _jax_shapes(tree) -> dict:
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


_STACKED = re.compile(r"\['(blocks|lead|enc_blocks|dec_blocks|s_blocks)'\]"
                      r"\[(\d+)\](.*)")
_M_BLOCKS = re.compile(r"\['m_blocks'\]\[\d+\]\[\d+\](.*)")


def _jax_leaf(path: str, jax_tree: dict) -> tuple[str, int]:
    """The JAX leaf a port leaf was taken from, and how many stacked layer
    dims lead its shape there (``interop``'s layouts)."""
    m = _M_BLOCKS.fullmatch(path)
    if m:
        return "['m_blocks']" + m.group(1), 2
    m = _STACKED.fullmatch(path)
    if not m:
        return path, 0
    group, i, rest = m.group(1), int(m.group(2)), m.group(3)
    if group == "blocks" and "pairs" in jax_tree:
        return f"['pairs']['{('dense', 'moe')[i % 2]}']{rest}", 1
    if group == "blocks" and "lead" in jax_tree:
        n_lead = jax_tree["lead"]["ln1"].shape[0]
        return f"['{'lead' if i < n_lead else 'blocks'}']{rest}", 1
    return f"['{group}']{rest}", 1


def _port_shapes(tree) -> dict:
    """path -> shape of every leaf of a port tree (a host int's: ())."""
    return dict(sharding.spec_leaves(sharding.map_with_path(
        lambda _, leaf: tuple(getattr(leaf, "shape", ())), tree)))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("serve_2d", [False, True])
@pytest.mark.parametrize("fsdp", [None, True, False])
def test_param_specs_equal_jax(arch, serve_2d, fsdp):
    """Every port leaf's spec is JAX's with the stacked dims dropped (those
    unsharded), its shape JAX's without them, and every JAX leaf is some
    port leaf's source."""
    port, jtree = _params(arch)
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    j_shapes, p_shapes = _jax_shapes(jtree), _port_shapes(port)
    for which in MESHES:
        jmesh, mesh = _meshes(which)
        want = _jax_specs(j_sharding.param_shardings(
            jcfg, jtree, jmesh, fsdp=fsdp, serve_2d=serve_2d))
        got = dict(sharding.spec_leaves(sharding.param_shardings(
            cfg, port, mesh, fsdp=fsdp, serve_2d=serve_2d)))
        assert set(got) == set(p_shapes)
        sources = set()
        for path, spec in got.items():
            src, n = _jax_leaf(path, jtree)
            sources.add(src)
            label = (which, path, src)
            assert j_shapes[src][n:] == p_shapes[path], label
            assert all(s is None for s in want[src][:n]), (label, want[src])
            assert spec == want[src][n:], (label, spec, want[src])
        assert sources == set(want), (which, set(want) ^ sources)


@functools.lru_cache(maxsize=None)
def _cells(arch):
    """shape name -> (port input specs, JAX input specs) of every cell the
    arch supports."""
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    return {shape: (registry.input_specs(cfg, shape),
                    j_registry.input_specs(jcfg, shape))
            for shape in registry.SHAPES if registry.supports(cfg, shape)}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_specs_equal_jax(arch):
    """Batch and cache specs of every supported cell equal JAX's on both
    meshes, leaf for leaf (the caches are stacked in both packages; the
    port's host-int "len" and JAX's scalar both get ())."""
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    for shape, (port, jspec) in _cells(arch).items():
        assert registry.supports(cfg, shape) == j_registry.supports(
            jcfg, shape)
        for which in MESHES:
            jmesh, mesh = _meshes(which)
            for key, rule, j_rule in (
                    ("batch", sharding.batch_shardings,
                     j_sharding.batch_shardings),
                    ("cache", sharding.cache_shardings,
                     j_sharding.cache_shardings)):
                if key not in jspec:
                    assert key not in port
                    continue
                got = dict(sharding.spec_leaves(rule(cfg, port[key], mesh)))
                want = _jax_specs(j_rule(jcfg, jspec[key], jmesh))
                assert got == want, (arch, shape, which, key)
                shapes = _jax_shapes(jspec[key])
                for path, s in _port_shapes(port[key]).items():
                    assert s == shapes[path], (arch, shape, path)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_sharding_matrix.py.
# ---------------------------------------------------------------------------

def _check_divisible(tree, specs, mesh):
    shapes = _port_shapes(tree)
    for path, spec in sharding.spec_leaves(specs):
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            n = math.prod(mesh.shape[ax] for ax in
                          (axes if isinstance(axes, tuple) else (axes,)))
            assert shapes[path][dim] % n == 0, (path, shapes[path], spec)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("serve_2d", [False, True])
def test_param_shardings_divisible(arch, serve_2d):
    cfg = configs.get_config(arch)
    params = _params(arch)[0]
    for which in MESHES:
        mesh = _meshes(which)[1]
        _check_divisible(params, sharding.param_shardings(
            cfg, params, mesh, serve_2d=serve_2d), mesh)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_shardings_divisible(arch):
    cfg = configs.get_config(arch)
    for port, _ in _cells(arch).values():
        for which in MESHES:
            mesh = _meshes(which)[1]
            if "batch" in port:
                _check_divisible(port["batch"], sharding.batch_shardings(
                    cfg, port["batch"], mesh), mesh)
            if "cache" in port:
                _check_divisible(port["cache"], sharding.cache_shardings(
                    cfg, port["cache"], mesh), mesh)


def test_split_kv_cache_sharding_when_heads_indivisible():
    """command-r: 8 kv heads < model = 16 -> the cache shards its sequence
    dim over model (split-KV decode) instead of replicating."""
    cfg = configs.get_config("command-r-35b")
    cache = registry.build_model(cfg).init_cache(128, 32768, device="meta")
    sh = sharding.cache_shardings(cfg, cache, _meshes("single_pod")[1])
    assert sh["k"][2] == "model", sh["k"]
    assert sh["k"][1] == "data", sh["k"]


def test_param_bytes_per_rank_fit_serving():
    """Serving layout: every arch's bf16 weights are under 16e9 bytes a
    rank on the single-pod mesh (the JAX test's figure, the production
    mesh's rule; the KV cache is accounted per cell)."""
    mesh = _meshes("single_pod")[1]
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_config(arch)
        params = _params(arch)[0]
        shapes = _port_shapes(params)
        per_rank = 0
        for path, spec in sharding.spec_leaves(sharding.param_shardings(
                cfg, params, mesh, serve_2d=True)):
            n_shards = 1
            for axes in spec:
                for ax in specs.as_axes(axes):
                    n_shards *= mesh.shape[ax]
            per_rank += math.prod(shapes[path]) * 2 / n_shards  # bf16
        assert per_rank < 16e9, (arch, per_rank / 1e9)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_distributed.py's rule tests.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b", "xlstm-1.3b",
                                  "hymba-1.5b"])
def test_param_sharding_rules_shapes(arch):
    """A spec for every leaf, each as long as its leaf's shape."""
    cfg = configs.get_config(arch)
    params = _params(arch)[0]
    specs = dict(sharding.spec_leaves(sharding.param_shardings(
        cfg, params, _meshes("single_pod")[1])))
    shapes = _port_shapes(params)
    assert set(specs) == set(shapes)
    assert all(len(specs[p]) == len(shapes[p]) for p in shapes)


def test_vocab_tables_never_fsdp_sharded():
    """The embed / unembed FSDP exemption."""
    cfg = configs.get_config("gemma-2b")
    sh = sharding.param_shardings(cfg, _params("gemma-2b")[0],
                                  _meshes("single_pod")[1], fsdp=True)
    assert "data" not in sh["embed"], sh["embed"]


def test_expert_dim_sharded_on_model():
    cfg = configs.get_config("deepseek-v2-236b")
    params = _params("deepseek-v2-236b")[0]
    sh = sharding.param_shardings(cfg, params, _meshes("single_pod")[1],
                                  fsdp=False)
    moe_layer = cfg.n_dense_leading          # the first MoE layer
    spec = sh["blocks"][moe_layer]["ffn"]["routed"]["w_gate"]  # (E, d, f)
    assert spec[0] == "model", spec


def test_cache_sequence_parallel_fallback():
    """batch = 1 long-context cells shard the cache on the sequence dim."""
    cfg = configs.get_config("gemma3-1b")
    cache = registry.build_model(cfg).init_cache(1, 4096, device="meta")
    sh = sharding.cache_shardings(cfg, cache, _meshes("single_pod")[1])
    assert sh["k"][2] == "data", sh["k"]


def test_serve_2d_param_shardings():
    """Serving layout: weights stationary on both axes, no FSDP gathers."""
    cfg = configs.get_config("deepseek-v2-236b")
    sh = sharding.param_shardings(cfg, _params("deepseek-v2-236b")[0],
                                  _meshes("single_pod")[1], serve_2d=True)
    layer = sh["blocks"][cfg.n_dense_leading]
    spec = layer["attn"]["wq_b"]                 # (q_lora, H * (dn + dr))
    assert spec[-1] == "model" and spec[-2] == "data", spec
    espec = layer["ffn"]["routed"]["w_gate"]     # (E, d, f)
    assert espec[0] == "model" and espec[2] == "data", espec


def test_fsdp_auto_switch_and_xlstm_fsdp_only():
    """fsdp=None turns FSDP on above 2e9 parameters (gemma3-1b stays off,
    command-r on); xlstm's 4 heads < model 16: its projections are
    FSDP-only, over (data, model)."""
    mesh = _meshes("single_pod")[1]
    small = dict(sharding.spec_leaves(sharding.param_shardings(
        configs.get_config("gemma3-1b"), _params("gemma3-1b")[0], mesh)))
    assert not any("data" in specs.as_axes(a)
                   for spec in small.values() for a in spec)
    big = sharding.param_shardings(configs.get_config("command-r-35b"),
                                   _params("command-r-35b")[0], mesh)
    assert "data" in big["blocks"][0]["attn"]["wq"], big["blocks"][0]
    x = sharding.param_shardings(configs.get_config("xlstm-1.3b"),
                                 _params("xlstm-1.3b")[0], mesh)
    spec = x["m_blocks"][0][0]["w_up"]
    assert ("data", "model") in spec and "model" not in spec, spec


def test_placements_order_and_local_slices():
    """A dim over (pod, data) is split pod-major, as JAX's (pod, data)
    spec; axes out of the mesh's order are refused; ``local_slices``
    follows the coordinates."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = Mesh(("pod", "data", "model"), (2, 4, 2))
    assert specs.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert specs.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        specs.placements((("data", "pod"),), mesh)
    assert specs.local_slices((("pod", "data"), None), (16, 6), mesh) == (
        slice(0, 2), slice(0, 6))


# ---------------------------------------------------------------------------
# The mesh context: constraint_spec against JAX's constrain.
# ---------------------------------------------------------------------------

def _call_sites(arch) -> list[tuple[tuple, tuple]]:
    """(logical names, shape) of the models' constrain calls at the arch's
    train_4k and long-context shapes: the final hidden state and logits
    (transformer / encdec / xlstm), MLA's float32 caches, the MoE generic
    path's gathered slots, expert buffers and outputs."""
    cfg = configs.get_config(arch)
    out = []
    for b, s in ((256, 4096), (1, 4096), (6, 7)):
        out += [(("batch", None, None), (b, s, cfg.d_model)),
                (("batch", None, "vocab"), (b, s, cfg.vocab_size))]
        if cfg.family == "mla_moe":
            out.append((("batch", None, None), (b, s, cfg.kv_lora_rank)))
        if cfg.n_experts:
            t, k, e = b * s, cfg.n_experts_per_token, cfg.n_experts
            cap = moe._capacity(t, k, e, cfg.capacity_factor)
            out += [(("batch", None), (t * k, cfg.d_model)),
                    (("expert", None, None), (e, cap, cfg.d_model)),
                    (("batch", None), (t, cfg.d_model))]
    return out


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_constraint_spec_equals_jax_constrain(arch, monkeypatch):
    """The spec ``constrain`` pins each call site to equals the one JAX's
    ``constrain`` hands ``with_sharding_constraint`` (captured), on both
    meshes and on a (data, model) mesh without a pod axis of 3 x 5."""
    seen = []
    monkeypatch.setattr(j_api.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    meshes = [_meshes(w) for w in MESHES] + [(
        abstract_mesh((3, 5), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2),
        Mesh(("data", "model"), (3, 5)))]
    for jmesh, mesh in meshes:
        j_api.set_mesh(jmesh)
        try:
            for names, shape in _call_sites(arch):
                seen.clear()
                j_api.constrain(jax.ShapeDtypeStruct(shape, "float32"),
                                *names)
                assert seen == [api.constraint_spec(shape, names, mesh)], (
                    mesh.shape, names, shape)
        finally:
            j_api.set_mesh(None)


def test_constrain_without_a_mesh_or_on_a_plain_tensor_is_a_no_op():
    import torch

    x = torch.zeros(4, 3)
    assert api.constrain(x, "batch", None) is x
    api.set_mesh(Mesh(("data", "model"), (2, 2)))
    try:
        assert api.constrain(x, "batch", None) is x
    finally:
        api.set_mesh(None)
    assert api.resolve("batch", Mesh(("data",), (4,))) == "data"
    assert api.resolve("batch", Mesh(("pod", "data"), (2, 4))) == (
        "pod", "data")
    assert api.resolve("expert", Mesh(("data",), (4,))) is None
