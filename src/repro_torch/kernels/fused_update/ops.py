"""Wrappers around the fused resident-step kernel: the stacked ``(m, d)``
layout, device routing, and the launch count.

``fused_step_buf`` is the one entry to the kernel.  For tensors on the CPU
it runs the plain PyTorch version (``ref.fused_step_math``); for CUDA
tensors it checks them, launches the CUDA kernel and adds one to
``launches``, or raises.  There is no fallback from the kernel to the plain
version.

The layout is the port's own: contiguous row-major ``(m, d)`` float32, one
row per node, no padding (the reference's (8, 128) tile padding,
``stacked_layout`` / ``pad_mix_matrix``, served the TPU only).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import kernel, ref

__all__ = ["FUSED_MIN_D", "fused_wins", "flatten_stacked",
           "unflatten_stacked", "tree_node_dim", "fused_step_buf",
           "fused_resident_step", "launches"]

# Launches of the CUDA kernel since the count was last set to 0: one per
# kernel launch, counted by fused_step_buf and nowhere else.
launches = 0

# kernel="auto" runs the fused step at per-node sizes d >= FUSED_MIN_D: the
# smallest d at which chip_smoke.py timed the fused update against the
# plain one on the H100 (it won at every d timed, 30 to 131,072; see
# PERF.md).  Below it nothing was measured, so "auto" keeps the plain step.
FUSED_MIN_D = 30


def fused_wins(d: int) -> bool:
    """Whether kernel="auto" picks the fused step at per-node size ``d``."""
    return int(d) >= FUSED_MIN_D


def flatten_stacked(tree, m: int):
    """Tree of (m, ...) leaves -> (contiguous (m, d) float32 buffer, aux).
    A single contiguous float32 leaf is returned as a view, not copied."""
    leaves, spec = pytree.tree_flatten(tree)
    flat = [leaf.reshape(m, -1) for leaf in leaves]
    buf = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    buf = buf.to(torch.float32).contiguous()
    shapes = [tuple(leaf.shape) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    return buf, (spec, shapes, dtypes)


def unflatten_stacked(buf, aux):
    spec, shapes, dtypes = aux
    leaves, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        size = int(np.prod(shp[1:], dtype=np.int64))
        leaves.append(buf[:, off:off + size].reshape(shp).to(dt))
        off += size
    return pytree.tree_unflatten(leaves, spec)


def tree_node_dim(tree) -> int:
    """Per-node flattened parameter count of a stacked (m, ...) tree."""
    return sum(int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64))
               for leaf in pytree.tree_leaves(tree))


def _check_cuda_operands(w, streams, alpha, rule: str, prox_kind: str):
    if rule not in kernel.RULES:
        raise ValueError(f"unknown fused rule {rule!r}; have "
                         f"{ref.FUSED_RULES}")
    if prox_kind not in kernel.PROXES:
        raise ValueError(f"unknown fused prox kind {prox_kind!r}; have "
                         f"{ref.FUSED_PROXES}")
    want = 4 if rule == "svrg" else 2
    if len(streams) != want:
        raise ValueError(f"rule {rule!r} takes {want} streams, got "
                         f"{len(streams)}")
    x = streams[0]
    if x.ndim != 2:
        raise ValueError(f"streams must be (m, d), got {tuple(x.shape)}")
    m, d = x.shape
    tensors = list(streams) + [w]
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError("alpha must be a scalar")
        tensors.append(alpha)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    for s in streams:
        if tuple(s.shape) != (m, d):
            raise ValueError(f"stream shape {tuple(s.shape)} != {(m, d)}")
    if tuple(w.shape) != (m, m):
        raise ValueError(f"mixing matrix {tuple(w.shape)} != {(m, m)}")
    if m > kernel.max_m():
        raise ValueError(f"the fused kernel takes at most {kernel.max_m()} "
                         f"nodes, got m={m}")


def fused_step_buf(w, streams, alpha, lam, *, rule: str = "svrg",
                   prox_kind: str = "l1"):
    """prox(W @ (x - alpha*v)) over stacked (m, d) float32 buffers.

    ``streams``: (x, g_now, g_snap, mu) for rule="svrg", (x, g) for "sgd".
    ``alpha``: a Python float or a one-element float32 tensor on the
    buffers' device; ``lam``: a Python float.  CPU tensors run the plain
    version; CUDA tensors launch the kernel; any other device raises.
    """
    global launches
    streams = tuple(streams)
    device = streams[0].device
    if device.type == "cpu":
        return ref.fused_step_math(w, streams, alpha, lam, rule=rule,
                                   prox_kind=prox_kind)
    if device.type != "cuda":
        raise ValueError(f"the fused step runs on CUDA (kernel) or CPU "
                         f"(plain version), not on {device}")
    _check_cuda_operands(w, streams, alpha, rule, prox_kind)
    out = torch.empty_like(streams[0])
    rc = kernel.fused_step_launch(w, streams, out, alpha, lam, rule=rule,
                                  prox_kind=prox_kind)
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed with status "
                           f"{rc}")
    launches += 1
    return out


def fused_resident_step(w, x_tree, grad_trees, alpha, lam, *, rule: str,
                        prox_kind: str):
    """Tree-level fused step: prox(W @ (x - alpha*v)).

    ``w``: dense (m, m) float32 mixing matrix on the parameters' device.
    ``grad_trees``: (g_now, g_snap, mu) for rule="svrg", (g,) for "sgd" —
    all with the stacked (m, ...) structure of ``x_tree``.
    """
    m = pytree.tree_leaves(x_tree)[0].shape[0]
    x_buf, aux = flatten_stacked(x_tree, m)
    streams = [x_buf] + [flatten_stacked(t, m)[0] for t in grad_trees]
    out = fused_step_buf(w.contiguous(), streams, alpha, lam, rule=rule,
                         prox_kind=prox_kind)
    return unflatten_stacked(out, aux)
