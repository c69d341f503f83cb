"""Mixture-of-Experts layer with sort-scatter dispatch, the counterpart of
``repro.models.moe``: the generic path, and the expert-parallel path over
the ranks of a registered mesh (``_apply_moe_ep``).

Used by llama4-maverick (128 routed top-1 + 1 shared, alternating layers)
and deepseek-v2 (160 routed top-6 + 2 shared, fine-grained d_ff).

Dispatch, as in the JAX package:
  1. router logits -> top-k expert ids + renormalized combine weights per
     token; ties go to the lower expert index (``jax.lax.top_k``'s order;
     ``torch.topk`` promises none, so a stable descending sort picks);
  2. the (token, k) slots sorted by expert id (stable);
  3. each slot's position within its expert (``searchsorted``); slots past
     the capacity C are dropped (GShard-style), their token values zeroed;
  4. one grouped product runs all experts' MLPs: (E, C, d) x (E, d, f),
     as batched matrix products (the JAX package computes it with einsums,
     outside any Pallas kernel);
  5. results gathered back and combined with the routing weights.

The scatter into the expert buffers writes each kept slot to its own row
(dropped slots write zeros to a spare row), and the combine sums a token's
k slots in a fixed order -- by ascending expert id, the order in which the
JAX package's sorted scatter-add visits them -- so nothing sums with
atomics and a run gives the same bits every time.  At decode (T = batch
tokens) the capacity is its floor of 8 and the grouped product reads every
expert's weights, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives, specs
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype: torch.dtype = layers.F32) -> Params:
    """``dtype`` is that of every matrix (the router, the expert stacks and
    the shared MLP)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": layers.dense_init(gen, d, e, device=device, dtype=dtype),
        "routed": {
            "w_gate": layers._normal(gen, (e, d, f), device,
                                     lambda x: x.mul_(scale_in), dtype),
            "w_up": layers._normal(gen, (e, d, f), device,
                                   lambda x: x.mul_(scale_in), dtype),
            "w_down": layers._normal(gen, (e, f, d), device,
                                     lambda x: x.mul_(scale_out), dtype),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(
            gen, d, cfg.d_ff_expert * cfg.n_shared_experts, cfg.mlp_kind,
            device=device, dtype=dtype)
    return p


def _capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    cap = int(n_tokens * k * factor / n_experts)
    return max(8, (cap + 7) // 8 * 8)  # pad to a lane-friendly multiple


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, ties to the lower index
    (``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig):
    """(T, d) tokens -> (float32 router probabilities (T, E), renormalized
    gate values (T, k), expert ids (T, k))."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.n_experts_per_token)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, -1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_ids


def _aux_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
              e: int) -> torch.Tensor:
    """The load-balancing loss (Switch/GShard form): E times the dot of the
    mean router probability and the share of tokens whose first choice is
    each expert, float32."""
    me = torch.mean(probs, dim=0)
    # one-hot by comparison: F.one_hot reads the ids' max on the host,
    # which torch.func.vmap cannot
    first = expert_ids[:, :1] == torch.arange(e, device=probs.device)
    ce = torch.mean(first.float(), dim=0)
    return e * torch.sum(me * ce)


def _dispatch(xt: torch.Tensor, expert_ids: torch.Tensor,
              gate_vals: torch.Tensor, w: Params, cap: int,
              spare: bool = False) -> torch.Tensor:
    """Sort-scatter dispatch of (T, d) tokens to the E_w experts whose
    stacks ``w`` holds, ``cap`` slots each, and the combine: (T, d), each
    token's sum over its slots (a slot past the capacity adds 0).  With
    ``spare``, an id of E_w names a group held nowhere here (the expert-
    parallel path's slots routed to other ranks): its slots are sorted
    and placed like any group's, and read back zeros."""
    dtype, dev = xt.dtype, xt.device
    t, d = xt.shape
    k = expert_ids.shape[-1]
    e_w = w["w_gate"].shape[0]
    groups = e_w + int(spare)

    flat_expert = expert_ids.reshape(-1)                       # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    sorted_gate = gate_vals.reshape(-1)[order]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(groups, device=dev,
                                    dtype=sorted_expert.dtype), side="left")
    pos_in_expert = (torch.arange(t * k, device=dev)
                     - group_start[sorted_expert])
    keep = pos_in_expert < cap                                 # capacity drop
    dest = sorted_expert * cap + torch.where(keep, pos_in_expert, 0)

    # kept slots own their rows; dropped ones (zeros) go to a spare row.
    # Out of place (a scatter into a fresh buffer), so torch.func.vmap
    # and grad go through it.
    gathered = dist_api.constrain(xt[sorted_token], "batch", None)
    gathered = gathered * keep[:, None].to(dtype)
    rows = torch.where(keep, dest, groups * cap)
    buf = torch.zeros((groups * cap + 1, d), dtype=dtype, device=dev).scatter(
        0, rows[:, None].expand(t * k, d), gathered)
    buf = dist_api.constrain(buf[:e_w * cap].reshape(e_w, cap, d),
                             "expert", None, None)

    # ---- expert MLPs: one grouped product over the expert axis ----
    h = F.silu(torch.bmm(buf, w["w_gate"].to(dtype))) * torch.bmm(
        buf, w["w_up"].to(dtype))
    expert_out = dist_api.constrain(torch.bmm(h, w["w_down"].to(dtype)),
                                    "expert", None, None)
    expert_out = expert_out.reshape(e_w * cap, d)
    if spare:
        expert_out = torch.cat([expert_out, expert_out.new_zeros(cap, d)])

    # ---- gather back + combine, a token's slots by ascending expert ----
    slot_out = dist_api.constrain(expert_out[dest], "batch", None)
    slot_out = slot_out * (sorted_gate * keep)[:, None].to(dtype)
    per_slot = slot_out[torch.argsort(order)]   # back to (token, k) order
    by_expert = torch.argsort(expert_ids, dim=-1, stable=True)  # (T, k)
    per_slot = torch.gather(per_slot.reshape(t, k, d), 1,
                            by_expert[..., None].expand(t, k, d))
    out = per_slot[:, 0]
    for j in range(1, k):
        out = out + per_slot[:, j]
    return dist_api.constrain(out, "batch", None)


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[ax] for ax in mesh.axis_names
                     if ax in ("pod", "data"))


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()).

    aux_loss is the load-balancing loss (``_aux_loss``), float32, for the
    training objective.

    With a registered mesh whose ``model`` axis divides E, whose data
    axes divide the T tokens, and T >= 8 E, dispatch runs on the
    expert-parallel path (``_apply_moe_ep``), as the JAX package's does;
    decode-sized calls (T ~ batch) stay on the generic path."""
    mesh = dist_api.get_mesh()
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    if (mesh is not None and "model" in mesh.axis_names
            and e % mesh.shape["model"] == 0
            and t % _data_size(mesh) == 0 and t >= 8 * e):
        return _apply_moe_ep(p, x, cfg, mesh)
    cap = _capacity(t, cfg.n_experts_per_token, e, cfg.capacity_factor)
    xt = x.reshape(t, d)
    probs, gate_vals, expert_ids = route(p, xt, cfg)
    aux_loss = _aux_loss(probs, expert_ids, e)
    out = _dispatch(xt, expert_ids, gate_vals, p["routed"], cap)
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xt, cfg.mlp_kind, x.dtype)
    return out.reshape(b, s, d), aux_loss


# ---------------------------------------------------------------------------
# Expert parallelism over ranks.
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor, spec: tuple, mesh,
           grad_partial: tuple[str, ...]) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: ``t`` a ``DTensor`` over
    the mesh (what its spec splits and ``spec`` does not is gathered: an
    FSDP-sharded weight), or a plain tensor holding the whole value on
    every rank (sliced; no collective).  The gradient of the block is a
    partial sum over ``grad_partial``: the axes whose ranks each add a
    share of it."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        src, t = specs.spec_of(t, mesh), t.to_local()
    else:
        src = (None,) * t.dim()
    return collectives.relayout(t, mesh, src, spec,
                                grad_partial=grad_partial)


def _grad_once(t: torch.Tensor, first: bool) -> torch.Tensor:
    """``t`` with its gradient passed on only where ``first``: every model
    rank computes ``t`` alike, and the model axis sums the gradients of
    its inputs, so one rank must carry it.  The graph stays the same on
    every rank, so their backward collectives still pair up."""
    return t.detach() + (t - t.detach()) * float(first)


def _apply_moe_ep(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh):
    """Expert-parallel dispatch, each rank running its own part (the JAX
    package's ``shard_map`` body).

    Tokens are split over (pod, data) and replicated over ``model``; each
    model rank owns E / model_n experts.  Every rank routes its tokens,
    selects the slots routed to ITS experts (local sort-scatter with
    per-data-shard capacity and a spare row for the rest), runs its
    experts, combines their outputs by token, and one all-reduce of the
    (T_loc, d) partial outputs over ``model`` sums them -- each token's
    expert lives on exactly one model rank, so the sum is exact.  The aux
    loss is averaged over the data axes.  The shared experts are added
    after the all-reduce.

    ``x`` and the parameters are ``DTensor``s over the mesh (``reshard``'s
    output: leaves FSDP-sharded over the data axes are gathered first, as
    GSPMD gathers them to meet shard_map's in_specs) or plain tensors
    holding the whole value on every rank.  The output and aux come back
    as ``x`` came: a ``DTensor`` (out split over the data axes, aux
    replicated) or the whole value on every rank.  Gradients are the
    whole program's, as a ``DTensor``'s are: a parameter's (or a plain
    input's) is the same on every rank.  The expert products are PyTorch
    ops (``bmm``), as in the generic path."""
    from torch.distributed.tensor import DTensor

    if mesh.device_mesh is None and mesh.size > 1:
        raise ValueError(f"mesh {mesh.shape} has no ranks: the expert-"
                         f"parallel path runs over a mesh from "
                         f"launch.mesh.make_mesh")
    dtype = x.dtype
    b, s, d = x.shape
    t = b * s
    k = cfg.n_experts_per_token
    e = cfg.n_experts
    model_n = mesh.shape["model"]
    e_loc = e // model_n
    data_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    data_spec = (data_axes if len(data_axes) > 1
                 else data_axes[0] if data_axes else None)
    data_n = _data_size(mesh)
    t_loc = t // data_n
    cap = _capacity(t_loc, k, e, cfg.capacity_factor)
    j = mesh.coordinate("model")
    every = tuple(mesh.axis_names)

    if isinstance(x, DTensor):       # split on its batch dim
        xt = _local(x, (data_spec, None, None), mesh, ("model",))
        xt = xt.reshape(t_loc, d)
    else:
        xt = _local(x.reshape(t, d), (data_spec, None), mesh, ("model",))
    router = _local(p["router"], (None, None), mesh, every)
    w = {name: _local(p["routed"][name], ("model", None, None), mesh,
                      data_axes)
         for name in ("w_gate", "w_up", "w_down")}

    probs, gate_vals, expert_ids = route({"router": router}, xt, cfg)
    aux = collectives.sum_over(
        _grad_once(_aux_loss(probs, expert_ids, e), j == 0) / data_n,
        mesh, data_axes)
    lo = j * e_loc
    mine = (expert_ids >= lo) & (expert_ids < lo + e_loc)
    local_ids = torch.where(mine, expert_ids - lo, e_loc)  # e_loc: elsewhere
    out = collectives.sum_over(
        _dispatch(xt, local_ids, gate_vals, w, cap, spare=True), mesh,
        ("model",))
    if "shared" in p:
        shared = {name: _local(leaf, (None,) * leaf.dim(), mesh, every)
                  for name, leaf in p["shared"].items()}
        out = out + _grad_once(
            layers.apply_mlp(shared, xt, cfg.mlp_kind, dtype), j == 0)

    if not isinstance(x, DTensor):
        out = collectives.relayout(out, mesh, (data_spec, None), (None, None))
        return out.reshape(b, s, d), aux
    out = specs.as_dtensor(out.reshape(b // data_n, s, d),
                           (data_spec, None, None), (b, s, d), mesh)
    return out, specs.as_dtensor(aux, (), (), mesh)


def apply_moe_dense_ref(p: Params, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """Oracle: run every expert densely and combine by routing weights.
    O(E) compute -- tests only."""
    dtype = x.dtype
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate_vals, expert_ids = route(p, xt, cfg)
    weights = torch.zeros_like(probs).scatter(-1, expert_ids, gate_vals)
    w = p["routed"]
    h = F.silu(torch.einsum("td,edf->tef", xt, w["w_gate"].to(dtype)))
    h = h * torch.einsum("td,edf->tef", xt, w["w_up"].to(dtype))
    y = torch.einsum("tef,efd->ted", h, w["w_down"].to(dtype))
    out = torch.einsum("ted,te->td", y, weights.to(dtype))
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xt, cfg.mlp_kind, dtype)
    return out.reshape(b, s, d)
