"""Mixture-of-Experts layer with sort-scatter dispatch, the counterpart of
``repro.models.moe`` (its generic path; the expert-parallel path under a
mesh is the distributed layer's).

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


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()).

    aux_loss is the load-balancing loss (E times the dot of the mean router
    probability and the share of tokens whose first choice is each
    expert), float32, for the training objective."""
    dtype = x.dtype
    b, s, d = x.shape
    t = b * s
    k = cfg.n_experts_per_token
    e = cfg.n_experts
    cap = _capacity(t, k, e, cfg.capacity_factor)
    dev = x.device

    xt = x.reshape(t, d)
    probs, gate_vals, expert_ids = route(p, xt, cfg)

    # ---- load-balancing aux loss (Switch/GShard form) ----
    me = torch.mean(probs, dim=0)
    # one-hot by comparison: F.one_hot reads the ids' max on the host,
    # which torch.func.vmap cannot
    first = expert_ids[:, :1] == torch.arange(e, device=dev)
    ce = torch.mean(first.float(), dim=0)
    aux_loss = e * torch.sum(me * ce)

    # ---- sort-scatter dispatch ----
    flat_expert = expert_ids.reshape(-1)                       # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    sorted_gate = gate_vals.reshape(-1)[order]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev, dtype=sorted_expert.dtype),
        side="left")
    pos_in_expert = (torch.arange(t * k, device=dev)
                     - group_start[sorted_expert])
    keep = pos_in_expert < cap                                 # capacity drop
    dest = sorted_expert * cap + torch.where(keep, pos_in_expert, 0)

    # kept slots own their rows; dropped ones (zeros) go to a spare row.
    # Out of place (a scatter into a fresh buffer), so torch.func.vmap
    # and grad go through it.
    gathered = xt[sorted_token] * keep[:, None].to(dtype)
    rows = torch.where(keep, dest, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=dev).scatter(
        0, rows[:, None].expand(t * k, d), gathered)
    buf = buf[:e * cap].reshape(e, cap, d)

    # ---- expert MLPs: one grouped product over the expert axis ----
    w = p["routed"]
    h = F.silu(torch.bmm(buf, w["w_gate"].to(dtype))) * torch.bmm(
        buf, w["w_up"].to(dtype))
    expert_out = torch.bmm(h, w["w_down"].to(dtype)).reshape(e * cap, d)

    # ---- gather back + combine, a token's slots by ascending expert ----
    slot_out = expert_out[dest] * (sorted_gate * keep)[:, None].to(dtype)
    per_slot = slot_out[torch.argsort(order)]   # back to (token, k) order
    by_expert = torch.argsort(expert_ids, dim=-1, stable=True)  # (T, k)
    per_slot = torch.gather(per_slot.reshape(t, k, d), 1,
                            by_expert[..., None].expand(t, k, d))
    out = per_slot[:, 0]
    for j in range(1, k):
        out = out + per_slot[:, j]

    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xt, cfg.mlp_kind, dtype)
    return out.reshape(b, s, d), aux_loss


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
