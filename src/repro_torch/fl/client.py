"""Client-side local training (the LC stage of the paper's round model).

``local_update`` runs E local SGD steps on one client's data and returns
the model delta, the payload of the UT stage.  FedProx's proximal term
(mu/2 ||w - w_global||^2) is supported; mu = 0 is FedAvg's plain local
SGD.  Gradients come from ``torch.func``, so the server maps the update
over clients (and the co-simulation over services) with
``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value

from repro_torch.tree import leaves, tree_map


def local_update(loss_fn: Callable, params, batches, lr: float = 0.1,
                 prox_mu: float = 0.0):
    """Returns (delta, mean_loss), delta = w_local_final - w_global.

    ``loss_fn(params, batch) -> scalar`` is functional; ``batches`` is a
    tree whose leaves carry a leading (E, ...) axis, one batch a step."""
    w_global = params

    def total(p, batch):
        loss = loss_fn(p, batch)
        if prox_mu > 0.0:
            sq = sum(torch.sum(torch.square((a - b).to(torch.float32)))
                     for a, b in zip(leaves(p), leaves(w_global)))
            loss = loss + 0.5 * prox_mu * sq
        return loss

    n_steps = leaves(batches)[0].shape[0]
    p, losses = params, []
    for e in range(n_steps):
        g, loss = grad_and_value(total)(p, tree_map(lambda x: x[e], batches))
        p = tree_map(lambda w, gr: (w - lr * gr).to(w.dtype), p, g)
        losses.append(loss)
    delta = tree_map(lambda a, b: a - b, p, w_global)
    return delta, torch.mean(torch.stack(losses))
