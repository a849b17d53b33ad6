"""Minimal functional optimizers over tensor trees: the port of
``repro.optim``.

The conventional centralized baselines (AdamW / momentum-SGD all-reduce
training) that DPSVRG is compared against at LM scale.  Functional, like
the reference: ``init(params) -> state`` and ``update(grads, state, lr)
-> (updates, state)``, the updates to be added to the parameters.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["Optimizer", "sgd", "adamw", "clip_by_global_norm", "global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]  # (grads, state, lr) -> (updates, state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in pytree.tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return pytree.tree_map(lambda leaf: leaf * scale.to(leaf.dtype),
                           tree), norm


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return pytree.tree_map(torch.zeros_like, params)

    def update(grads, state, lr):
        if momentum == 0.0:
            return pytree.tree_map(lambda g: -lr * g, grads), state
        new_m = pytree.tree_map(lambda m, g: momentum * m + g, state, grads)
        return pytree.tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        device = pytree.tree_leaves(params)[0].device
        return AdamState(mu=pytree.tree_map(torch.zeros_like, params),
                         nu=pytree.tree_map(torch.zeros_like, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def update(grads, state, lr, params=None):
        count = state.count + 1
        mu = pytree.tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                             state.mu, grads)
        nu = pytree.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                             state.nu, grads)
        # b ** count in float32, as the reference forms it (torch.full
        # fills on the device: no host-to-device copy)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), b2, device=c.device), c)

        def upd(m, v, p):
            step = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                step = step - lr * weight_decay * p
            return step

        if params is None:
            updates = pytree.tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = pytree.tree_map(upd, mu, nu, params)
        return updates, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)
