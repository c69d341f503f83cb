"""Parameter-server side: synchronous FedAvg rounds with straggler
mitigation.

``make_fl_round_step`` builds the full round: per-client local training
(``torch.func.vmap`` over the client axis) -> optional uplink compression
-> deadline-based straggler drop (a client of weight 0 is masked out of
the aggregate) -> weighted aggregation -> server step.  Everything is
written for ``vmap``, so the co-simulation maps a round over services as
well.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.fl import client as fl_client
from repro_torch.fl import compression as fl_comp
from repro_torch.tree import tree_map


def sanitize_weights(weights: torch.Tensor, weight_cap: float | None = None):
    """Returns ``(clean_weights, n_nonfinite)``: non-finite client weights
    are zeroed and counted, and with ``weight_cap`` each weight is clipped
    to it.  Finite, in-cap weights pass through bitwise."""
    finite = torch.isfinite(weights)
    n_bad = torch.sum((~finite).to(torch.int32))
    clean = torch.where(finite, weights, torch.zeros_like(weights))
    if weight_cap is not None:
        clean = torch.clamp(clean, max=weight_cap)
    return clean, n_bad


def fedavg_round(deltas, weights: torch.Tensor,
                 weight_cap: float | None = None):
    """Weighted average of per-client deltas (leaves (C, ...); weights
    (C,), zero = dropped straggler).  A dropped client is masked out of the
    numerator (``where`` on w > 0, not a bare multiply), so not even its
    non-finite delta contributes; a round with no positive weight returns
    an exactly zero delta.  Weights pass through ``sanitize_weights``."""
    weights, _ = sanitize_weights(weights, weight_cap)
    wsum = torch.sum(weights)
    denom = torch.clamp(wsum, min=1e-12)

    def agg(d):
        w = weights.reshape((-1,) + (1,) * (d.dim() - 1)).to(d.dtype)
        num = torch.sum(torch.where(w > 0, d * w, torch.zeros_like(d)),
                        dim=0)
        return torch.where(wsum > 0, num / denom.to(d.dtype),
                           torch.zeros_like(num))

    return tree_map(agg, deltas)


def make_fl_round_step(loss_fn: Callable, *, local_steps: int = 1,
                       client_lr: float = 0.1, server_lr: float = 1.0,
                       prox_mu: float = 0.0, compression: str = "none",
                       topk_frac: float = 0.01, error_feedback: bool = False,
                       aggregator: str = "fedavg", trim_frac: float = 0.1,
                       clip_norm: float | None = None, byz_f: int = 1,
                       weight_cap: float | None = None, attack=None):
    """Returns ``round(params, client_batches, client_weights) -> (params,
    metrics)``; client_batches leaves are (C, E, ...), C clients with E
    local steps each (``local_steps`` is the reference's signature; E is
    read from the batches).

    ``aggregator`` selects the reduction from ``fl.aggregation``'s
    registry; ``weight_cap`` bounds client-reported weights.  With
    ``error_feedback=True`` the step is ``round(params, client_batches,
    client_weights, residuals) -> (params, metrics, residuals')``,
    ``residuals`` params-shaped with a leading (C,) axis: each client adds
    its residual to the fresh delta before compressing and keeps what the
    compressor cut; a straggler (weight 0) transmits nothing and keeps its
    residual unchanged.

    ``attack`` is an optional ``chaos.clients.AttackSpec``: the returned
    step then takes a trailing argument ``byz``, the round's (C,) bool
    mask of Byzantine clients, and applies the attack to their deltas and
    weights before the aggregation (the weights are then always
    sanitized); a straggler's residual is gated on its reported weight.
    """
    from repro_torch.fl import aggregation as fl_agg

    if attack is not None:
        from repro_torch.chaos import clients as chaos_clients
        if not isinstance(attack, chaos_clients.AttackSpec):
            raise TypeError(f"attack must be a chaos.clients.AttackSpec, "
                            f"got {type(attack).__name__}")
        attack_fn = chaos_clients.attack_fn(attack)
    if compression not in fl_comp.METHODS:
        raise ValueError(
            f"unknown compression method {compression!r}; "
            f"available: {fl_comp.METHODS}")
    if aggregator == "fedavg":
        def agg_fn(deltas, weights):
            return fedavg_round(deltas, weights, weight_cap)
    else:
        agg_fn = fl_agg.get_aggregator(
            aggregator, trim_frac=trim_frac, clip_norm=clip_norm, byz_f=byz_f)

    def one_client(params, batches):
        delta, loss = fl_client.local_update(
            loss_fn, params, batches, lr=client_lr, prox_mu=prox_mu)
        if compression != "none":
            delta, _ = fl_comp.compress(compression, delta, topk_frac)
        return delta, loss

    def one_client_ef(params, batches, residual):
        delta, loss = fl_client.local_update(
            loss_fn, params, batches, lr=client_lr, prox_mu=prox_mu)
        delta, residual = fl_comp.compress(compression, delta, topk_frac,
                                           residual)
        return delta, loss, residual

    def _finish(params, deltas, losses, client_weights, byz):
        if attack is not None:
            deltas, client_weights = attack_fn(deltas, client_weights, byz)
        if weight_cap is not None or attack is not None:
            client_weights, n_bad_w = sanitize_weights(client_weights,
                                                       weight_cap)
        else:
            n_bad_w = torch.zeros((), dtype=torch.int32,
                                  device=client_weights.device)
        agg = agg_fn(deltas, client_weights)
        new_params = tree_map(lambda p, d: p + server_lr * d.to(p.dtype),
                              params, agg)
        wsum = torch.sum(client_weights)
        num = torch.sum(torch.where(client_weights > 0,
                                    losses * client_weights, 0.0))
        # all-straggler round: no participants -> loss 0, not 0 / clamp
        mean_loss = torch.where(wsum > 0, num / torch.clamp(wsum, min=1e-12),
                                0.0)
        return new_params, {"loss": mean_loss,
                            "participating": torch.sum(client_weights > 0),
                            "nonfinite_weights": n_bad_w}

    def round_step(params, client_batches, client_weights, byz=None):
        deltas, losses = vmap(one_client, in_dims=(None, 0))(
            params, client_batches)
        return _finish(params, deltas, losses, client_weights, byz)

    def round_step_ef(params, client_batches, client_weights, residuals,
                      byz=None):
        deltas, losses, new_resid = vmap(one_client_ef, in_dims=(None, 0, 0))(
            params, client_batches, residuals)
        part = client_weights > 0
        resid_out = tree_map(
            lambda new, old: torch.where(
                part.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                old.to(new.dtype)),
            new_resid, residuals)
        new_params, metrics = _finish(params, deltas, losses, client_weights,
                                      byz)
        return new_params, metrics, resid_out

    return round_step_ef if error_feedback else round_step


def init_residuals(params, n_clients: int):
    """Zero error-feedback residuals for ``n_clients`` clients: a
    params-shaped tree with a leading (C,) axis."""
    return tree_map(
        lambda p: torch.zeros((n_clients,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device), params)


def straggler_weights(round_latencies: torch.Tensor,
                      deadline: float) -> torch.Tensor:
    """1.0 for clients meeting the deadline, 0.0 for stragglers."""
    return (round_latencies <= deadline).to(torch.float32)
