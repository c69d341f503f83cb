"""Per-architecture parameter, batch and cache sharding rules, the
counterpart of ``repro.distributed.sharding``.

Strategy:
  * ``model`` axis: tensor parallelism -- attention QKV/output and MLP
    up/down projections column/row split; MoE experts split across the
    axis (expert parallelism); vocab and embedding sharded on the vocab
    dim.
  * ``data`` axis: batch data parallelism + FSDP: parameters additionally
    sharded on their largest remaining dim when it divides (ZeRO-3 style;
    a rank gathers a weight where its computation needs it whole).
  * ``pod`` axis (multi-pod only): outer data parallelism.

torch has no abstract mesh and no GSPMD, so the rules are pure functions
of leaf names, shapes and a mesh's axis names and sizes
(``launch.mesh.Mesh``: ``Mesh(names, sizes)`` records a shape without
ranks).  A spec is a tuple over a tensor's dims, as
``jax.sharding.PartitionSpec``: ``None`` (replicated), an axis name, or a
tuple of axis names, the dim split over them major to minor.  Rules are
name and shape driven: ``param_shardings`` matches leaf path suffixes
(the port's leaf names are the JAX package's: ``['routed']['w_gate']``,
``['wq']``) and checks divisibility before sharding any dim, falling back
to replication (hymba's 25 heads, xlstm's 4).

The port keeps per-layer lists where the JAX package stacks layers on
leading axes, and each rule reads the leaf's own shape: a port leaf's spec
is the JAX leaf's with the stacked dims dropped (no JAX rule puts an axis
on a stacked dim; ``tests/test_torch_sharding.py`` holds both for every
arch).  Caches are stacked in both packages, so their specs are equal.

``distributed.specs`` turns a spec into ``DTensor`` placements and this
rank's block: every rank runs its own part of the program (SPMD), holding
its slice.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.distributed.specs import Spec
from repro_torch.tree import leaves, leaves_with_names, unflatten

# (path regex, role) -- first match wins.  Roles name the logical layout;
# dims that don't divide are dropped to None at apply time.
_COL = "col"   # shard last dim on model axis
_ROW = "row"   # shard first (or matmul-in) dim on model axis
_VOCAB = "vocab"        # (V, d): shard V on model; NEVER FSDP the d dim --
_VOCAB_OUT = "vocab_out"  # sharding d over data makes the logits product
#                           contraction-sharded, and the full (B, S, V/16)
#                           logits are all-reduced across data.
_EXPERT = "expert"
_REPL = "repl"

_RULES: list[tuple[str, str]] = [
    # expert rule must precede the generic w_gate/w_up/w_down rules
    (r"\['routed'\]\['w_\w+'\]$", _EXPERT),
    (r"\['embed'\]$", _VOCAB),
    (r"\['unembed'\]$", _VOCAB_OUT),
    (r"\['w[qkv]'\]$", _COL),
    (r"\['wq_[ab]'\]$", _COL),
    (r"\['wkv_a'\]$", _COL),
    (r"\['wkv_b'\]$", _COL),
    (r"\['wo'\]$", _ROW),
    (r"\['w_gate'\]$", _COL),
    (r"\['w_up'\]$", _COL),
    (r"\['w_down'\]$", _ROW),
    (r"\['w_in'\]$", _COL),
    (r"\['w_bc'\]$", _COL),
    (r"\['w_dt'\]$", _COL),
    (r"\['w_out'\]$", _ROW),
    (r"\['w_mix_out'\]$", _ROW),
    (r"\['w_qkv'\]$", _COL),
    (r"\['w_if'\]$", _COL),
    (r"\['w_zifo'\]$", _COL),
    (r"\['router'\]$", _REPL),
]

FSDP_AUTO_PARAMS = 2_000_000_000   # fsdp=None turns FSDP on above this


# ---------------------------------------------------------------------------
# Trees (``repro_torch.tree``'s: a cache's "len" a host int).  Paths print
# as the JAX package's key paths (``['blocks'][3]['wq']``), the strings the
# rules match.
# ---------------------------------------------------------------------------

def map_with_path(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in leaves_with_names(tree)])


def spec_leaves(specs, path: str = "") -> list[tuple[str, Spec]]:
    """(path, spec) of every leaf of a spec tree (the specs are tuples,
    which ``repro_torch.tree`` would walk into)."""
    if isinstance(specs, dict):
        return [pair for k, v in specs.items()
                for pair in spec_leaves(v, f"{path}[{k!r}]")]
    if isinstance(specs, list):
        return [pair for i, v in enumerate(specs)
                for pair in spec_leaves(v, f"{path}[{i}]")]
    return [(path, specs)]


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(ax for ax in mesh.axis_names if ax in ("pod", "data"))


def _axes_size(mesh, axes) -> int:
    return math.prod(mesh.shape[ax] for ax in axes)


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------

def _divides(dim: int | None, n: int) -> bool:
    return dim is not None and n > 1 and dim % n == 0 and dim >= n


def _spec_for(role: str, shape: tuple[int, ...], mesh,
              data_axes: tuple[str, ...], fsdp: bool,
              serve_2d: bool) -> Spec:
    model_n = mesh.shape["model"]
    data_n = _axes_size(mesh, data_axes)
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    daxis = data_axes if len(data_axes) > 1 else data_axes[0]

    def try_set(dim_idx: int, axis, axis_n: int) -> bool:
        if spec[dim_idx] is None and _divides(shape[dim_idx], axis_n):
            spec[dim_idx] = axis
            return True
        return False

    last, first_mat = ndim - 1, max(ndim - 2, 0)
    if role == _VOCAB:
        try_set(first_mat, "model", model_n)      # (V, d): shard vocab
        fsdp = False
    elif role == _VOCAB_OUT:
        try_set(last, "model", model_n)           # (d, V): shard vocab
        fsdp = False
    elif role == _COL:
        try_set(last, "model", model_n)
        if serve_2d:
            # serving: weights stationary on BOTH axes -- the decode-sized
            # activation reduction is far cheaper than per-layer FSDP
            # weight gathers
            try_set(first_mat, daxis, data_n)
            fsdp = False
    elif role == _ROW:
        try_set(first_mat, "model", model_n)
        if serve_2d:
            try_set(last, daxis, data_n)
            fsdp = False
    elif role == _EXPERT:
        # (E, d, f): expert dim = ndim - 3
        if ndim >= 3:
            try_set(ndim - 3, "model", model_n)
        if serve_2d:
            try_set(last, daxis, data_n)
            fsdp = False
    # FSDP: shard one remaining (preferably large) dim over the data axes
    if fsdp and data_n > 1:
        order = sorted(range(ndim), key=lambda i: -shape[i])
        for i in order:
            if try_set(i, daxis, data_n):
                break
    return tuple(spec)


def param_shardings(cfg, params_tree: Any, mesh, *, fsdp: bool | None = None,
                    serve_2d: bool = False) -> Any:
    """The spec of every leaf of ``params_tree`` (tensors, on any device,
    ``meta`` included), as a tree of the same structure.

    ``fsdp=None`` turns FSDP on above FSDP_AUTO_PARAMS parameters (never
    with ``serve_2d``).  ``serve_2d=True`` applies the serving layout:
    matrix weights sharded on both (model, data) axes and never gathered
    (inference has no optimizer state and decode activations are tiny)."""
    data_axes = _data_axes(mesh)
    if fsdp is None:
        total = sum(math.prod(_shape(leaf)) for leaf in leaves(params_tree))
        fsdp = total > FSDP_AUTO_PARAMS and not serve_2d

    # TP-hostile archs (xlstm: 4 heads, head-blocked cells) would gather
    # activation-sized tensors every layer under COL/ROW model sharding;
    # pure FSDP over (data x model) gathers weights instead.
    fsdp_only = cfg.family == "ssm" and cfg.n_heads < mesh.shape.get(
        "model", 1)
    fsdp_axes = data_axes + ("model",) if fsdp_only else data_axes

    def leaf_spec(path, leaf):
        role = _REPL
        for pattern, r in _RULES:
            if re.search(pattern, path):
                role = r
                break
        if fsdp_only and role in (_COL, _ROW):
            role = _REPL
        return _spec_for(role, _shape(leaf), mesh, fsdp_axes,
                         fsdp or fsdp_only, serve_2d)

    return map_with_path(leaf_spec, params_tree)


def batch_shardings(cfg, batch_tree: Any, mesh) -> Any:
    """Batch dim over (pod, data); M-RoPE position streams have batch at
    index 1; everything else follows its leading dim.

    TP-hostile archs (see param_shardings' fsdp_only) extend the batch onto
    the otherwise idle model axis -- pure data parallelism + ZeRO -- when
    every batch leaf still divides."""
    data_axes = _data_axes(mesh)
    if cfg.family == "ssm" and cfg.n_heads < mesh.shape.get("model", 1):
        ext = data_axes + ("model",)
        n_ext = _axes_size(mesh, ext)
        sizes = {_shape(leaf)[0] for leaf in leaves(batch_tree)
                 if _shape(leaf)}
        if sizes and all(s % n_ext == 0 and s >= n_ext for s in sizes):
            data_axes = ext
    axes = data_axes if len(data_axes) > 1 else data_axes[0]
    data_n = _axes_size(mesh, data_axes)

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        batch_dim = 1 if "positions" in path and len(shape) == 3 else 0
        spec: list[Any] = [None] * len(shape)
        if _divides(shape[batch_dim], data_n):
            spec[batch_dim] = axes
        return tuple(spec)

    return map_with_path(leaf_spec, batch_tree)


def cache_shardings(cfg, cache_tree: Any, mesh) -> Any:
    """KV and state caches: batch over (pod, data) when divisible, else the
    sequence dim over (pod, data) (long-context batch = 1 cells); kv-head
    dims over model when divisible, else split-KV (the sequence dim over
    model).  The host-int ``"len"`` gets ``()``."""
    data_axes = _data_axes(mesh)
    axes = data_axes if len(data_axes) > 1 else data_axes[0]
    data_n = _axes_size(mesh, data_axes)
    model_n = mesh.shape["model"]

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        spec: list[Any] = [None] * len(shape)
        if not shape:  # "len"
            return ()
        if ("'k'" in path or "'v'" in path or "xk" in path or "xv" in path
                or "k_scale" in path or "v_scale" in path):
            # (L, B, S, Hkv, Dh) or the int8 scales (L, B, S, Hkv)
            if _divides(shape[1], data_n):
                spec[1] = axes
            elif _divides(shape[2], data_n):
                spec[2] = axes          # sequence-parallel cache (batch=1)
            if len(shape) >= 4 and _divides(shape[3], model_n):
                spec[3] = "model"
            elif spec[2] is None and _divides(shape[2], model_n):
                # kv heads don't divide the model axis (8 heads / 16):
                # split-KV decode -- the sequence dim over model, the
                # softmax reducing over it; otherwise the cache replicates
                # over model
                spec[2] = "model"
        elif "ckv" in path or "krope" in path:
            # (L, B, S, R)
            if _divides(shape[1], data_n):
                spec[1] = axes
            elif _divides(shape[2], data_n):
                spec[2] = axes
        else:
            # recurrent states: (..., B, ...): find the batch dim by size
            for i, s in enumerate(shape):
                if _divides(s, data_n):
                    spec[i] = axes
                    break
        return tuple(spec)

    return map_with_path(leaf_spec, cache_tree)


def replicated(mesh=None) -> Spec:
    """The spec of a tensor whole on every rank."""
    return ()
