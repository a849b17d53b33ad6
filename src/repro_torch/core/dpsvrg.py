"""DPSVRG (paper Algorithm 1) public surface + the centralized reference.

The port of ``repro.core.dpsvrg``.  The algorithms live behind the protocol
in ``repro_torch.core.algorithm`` and are driven by ``runner.run``::

    problem = algorithm.Problem(loss_fn, prox, x0_stacked, full_data)
    algo = algorithm.ALGORITHMS["dpsvrg"](problem, DPSVRGHyperParams(...))
    res = runner.run(algo, problem, schedule, ExecSpec(gossip="dense"),
                     record_every=...)

Algorithm 1 (per node i, inner step k of outer round s):
    v_i   = grad_B f_i(x_i) - grad_B f_i(x~_i) + full_grad_i(x~_i)
    q_i   = x_i - alpha * v_i
    q^_i  = sum_j Phi^(k,s)_{ij} q_j          (multi-consensus: k gossip rounds)
    x_i   = prox_h^alpha(q^_i)
outer: x~_i^s = (1/K_s) sum_k x_i^(k,s),  K_s = ceil(beta^s n0),
       x_i^(0,s+1) = x_i^(K_s,s).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import prox as prox_lib
from .algorithm import (DPSVRGHyperParams, DSPGHyperParams,
                        build_dpsvrg_inner_step, build_dspg_step,
                        build_node_full_grad_fn, build_node_grad_fn)
from .runner import RunHistory

__all__ = [
    "DPSVRGHyperParams",
    "DSPGHyperParams",
    "build_dpsvrg_inner_step",
    "build_dspg_step",
    "build_node_grad_fn",
    "build_node_full_grad_fn",
    "centralized_prox_gd",
    "RunHistory",
]


def centralized_prox_gd(loss_fn: Callable, prox: prox_lib.Prox, x0,
                        full_data_flat, alpha: float,
                        num_steps: int) -> tuple[Any, np.ndarray]:
    """Centralized full-batch proximal gradient — used to estimate F(x*) for
    the optimality-gap metric (paper Section V-B)."""
    g = torch.func.grad(loss_fn)
    hist = []
    x = x0
    for _ in range(num_steps):
        gr = g(x, full_data_flat)
        z = pytree.tree_map(lambda xi, gi: xi - alpha * gi, x, gr)
        x = prox.apply(z, alpha)
        hist.append(float(loss_fn(x, full_data_flat) + prox.value(x)))
    return x, np.array(hist)
