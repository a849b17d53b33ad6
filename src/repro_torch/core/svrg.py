"""SVRG variance-reduced gradient estimation (paper Section III-A).

The estimator at inner step (k, s):

    v_i = grad_B f_i(x_i)  -  grad_B f_i(x_tilde_i)  +  full_grad_i(x_tilde_i)

where ``x_tilde_i`` is the outer-loop snapshot and ``full_grad_i`` is the
full local gradient recomputed once per outer round.

The port of ``repro.core.svrg``.  Parameters are trees of tensors (a bare
tensor, or dicts / tuples / lists of them); every helper maps leaf-wise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["SvrgState", "init_snapshot", "corrected_gradient", "tree_sub",
           "tree_add", "tree_axpy", "tree_dot", "tree_norm"]


class SvrgState(NamedTuple):
    """Outer-loop snapshot state.

    snapshot:  x_tilde (same structure as params)
    full_grad: grad f(x_tilde) over the full local dataset (mu in SVRG papers)
    """
    snapshot: Any
    full_grad: Any


def tree_sub(a, b):
    return pytree.tree_map(torch.sub, a, b)


def tree_add(a, b):
    return pytree.tree_map(torch.add, a, b)


def tree_axpy(alpha, x, y):
    """y + alpha * x, leaf-wise."""
    return pytree.tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def tree_dot(a, b):
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def init_snapshot(params, full_grad_fn: Callable) -> SvrgState:
    """Take a snapshot at ``params`` and compute the full local gradient."""
    return SvrgState(snapshot=params, full_grad=full_grad_fn(params))


def corrected_gradient(grad_fn: Callable, params, state: SvrgState, batch):
    """The SVRG estimator v = g(x; B) - g(x_tilde; B) + mu, with both
    minibatch gradients taken on the *same* batch."""
    g_now = grad_fn(params, batch)
    g_snap = grad_fn(state.snapshot, batch)
    return pytree.tree_map(lambda a, b, mu: a - b + mu,
                           g_now, g_snap, state.full_grad)
