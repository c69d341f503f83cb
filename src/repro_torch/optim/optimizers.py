"""Minimal functional optimizers over the port's trees
(``repro_torch.tree``), the counterpart of ``repro.optim.optimizers``.

Each optimizer is an (init, update) pair closed over its hyperparameters;
``update(grads, state, params)`` returns (new_params, new_state), nothing
updated in place, so the pair composes with ``torch.func``.  The state is
an ``OptState`` of trees shaped like the params (a checkpoint saves it as
it saves them).  The update math runs in float32 and each result is cast
back to its param's dtype, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tree             # first moment / momentum
    nu: Tree | None      # second moment (None for SGD)


def global_norm(tree: Tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        warm = base_lr * (step + 1) / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return lr


def _zero_step(tree: Tree) -> torch.Tensor:
    first = leaves(tree)
    device = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float = 0.0, moment_dtype=torch.float32):
    """``moment_dtype=torch.bfloat16`` stores the moments rounded to bf16
    (half the optimizer state); the update math stays float32."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> OptState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                         params)
        return OptState(step=_zero_step(params), mu=zeros,
                        nu=tree_map(torch.clone, zeros))

    def update(grads: Tree, state: OptState, params: Tree):
        if max_grad_norm > 0.0:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(p, g, mu, nu):
            g32 = g.float()
            mu_n = b1 * mu.float() + (1 - b1) * g32
            nu_n = b2 * nu.float() + (1 - b2) * g32 * g32
            delta = ((mu_n / c1) / (torch.sqrt(nu_n / c2) + eps)
                     + weight_decay * p.float())
            return ((p.float() - lr_t * delta).to(p.dtype),
                    mu_n.to(moment_dtype), nu_n.to(moment_dtype))

        out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                      leaves(state.mu), leaves(state.nu))]
        new_params, new_mu, new_nu = (
            unflatten(params, [o[i] for o in out]) for i in range(3))
        return new_params, OptState(step=step, mu=new_mu, nu=new_nu)

    return init, update


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0,
        max_grad_norm: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> OptState:
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params) if momentum else None)
        return OptState(step=_zero_step(params), mu=mu, nu=None)

    def update(grads: Tree, state: OptState, params: Tree):
        if max_grad_norm > 0.0:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            new_mu = tree_map(lambda m, g: momentum * m + g.float(),
                              state.mu, grads)
            new_params = tree_map(
                lambda p, m: (p.float() - lr_t * m).to(p.dtype), params,
                new_mu)
            return new_params, OptState(step=step, mu=new_mu, nu=None)
        new_params = tree_map(
            lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype), params,
            grads)
        return new_params, OptState(step=step, mu=None, nu=None)

    return init, update
