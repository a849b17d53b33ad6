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
from . import runner
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
    the optimality-gap metric (paper Section V-B).  The objective history
    stays on the data's device until one pull at the end.  On the card (and
    ``runner.CUDA_GRAPHS``) one step is captured in a CUDA graph and
    replayed: the same kernels on the same buffers, without the host's
    dispatch of every step."""
    g = torch.func.grad(loss_fn)

    def step(x):
        gr = g(x, full_data_flat)
        z = pytree.tree_map(lambda xi, gi: xi - alpha * gi, x, gr)
        x = prox.apply(z, alpha)
        return x, loss_fn(x, full_data_flat) + prox.value(x)

    if num_steps > 0 and runner.CUDA_GRAPHS and \
            pytree.tree_leaves(x0)[0].is_cuda:
        return _replayed(step, x0, num_steps)
    hist = []
    x = x0
    for _ in range(num_steps):
        x, obj = step(x)
        hist.append(obj)
    return x, torch.stack(hist).double().cpu().numpy()


def _replayed(step: Callable, x0, num_steps: int) -> tuple[Any, np.ndarray]:
    """``num_steps`` of ``step`` on the card: one step (after a warm-up on
    the capture stream, which also gives the objective's dtype) captured
    into a CUDA graph that reads the iterate from static buffers and writes
    the next one back, and the objective into a static scalar; replayed
    ``num_steps`` times, each replay's objective copied into the history
    behind it on the same stream."""
    x = pytree.tree_map(torch.clone, x0)
    leaves = pytree.tree_leaves(x)
    stream = torch.cuda.current_stream(leaves[0].device)
    side = torch.cuda.Stream(leaves[0].device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        _, obj = step(x)
    stream.wait_stream(side)
    obj_buf = torch.empty_like(obj)
    hist = torch.empty((num_steps,) + tuple(obj.shape), dtype=obj.dtype,
                       device=obj.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new, obj = step(x)
        for buf, leaf in zip(leaves, pytree.tree_leaves(new)):
            buf.copy_(leaf)
        obj_buf.copy_(obj)
    for i in range(num_steps):
        graph.replay()
        hist[i].copy_(obj_buf)
    return x, hist.double().cpu().numpy()
