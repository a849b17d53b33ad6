"""Wrappers around the fused-update kernels: layouts, device routing, and
the launch counts.

``fused_step_buf`` is the entry to the fused resident step for one run,
``fused_step_cells_buf`` for the B cells of a batched sweep in one launch,
and ``svrg_step`` / ``mix_prox`` are the entries to the elementwise
pipeline.  For tensors on the CPU each runs its plain PyTorch version
(``ref``); for CUDA tensors it checks them, launches the CUDA kernel and
adds one to its count (``launches`` for fused_step, ``launches_cells`` for
its cell-batched launch, ``launches_svrg_step`` and ``launches_mix_prox``),
or raises.  There is no fallback from a kernel to its plain version.

``fused_resident_step``, the tree-level step the algorithms call, goes
through a ``torch.autograd.Function`` whose vmap rule is the cell-batched
launch: a batched sweep runs each cell's step under ``torch.func.vmap``
over the cell axis, which cannot look into a ctypes launch (a batched
tensor has no data pointer), and the rule turns the B cells' calls into one
``fused_step_cells_buf``.

The fused step's layout is the port's own: contiguous row-major ``(m, d)``
float32, one row per node, no padding (the reference's (8, 128) tile
padding, ``stacked_layout`` / ``pad_mix_matrix``, served the TPU only).
``svrg_step`` and ``mix_prox`` take contiguous float32 buffers of any shape
and length; ``flatten_tree`` keeps the reference's zero-padded
``(rows, 1024)`` layout so that both packages' buffers compare element by
element, though the kernels themselves need no padding.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import kernel, ref

__all__ = ["FUSED_MIN_D", "fused_wins", "flatten_stacked",
           "unflatten_stacked", "tree_node_dim", "fused_step_buf",
           "fused_step_cells_buf", "fused_resident_step", "launches",
           "launches_cells", "BLOCK_ROWS", "BLOCK_COLS",
           "flatten_tree", "unflatten_tree", "svrg_step", "mix_prox",
           "launches_svrg_step", "launches_mix_prox"]

# Launches of each CUDA kernel since its count was last set to 0: one per
# kernel launch, counted by its wrapper and nowhere else.
launches = 0                # fused_step (fused_step_buf)
launches_cells = 0          # fused_step over B cells (fused_step_cells_buf)
launches_svrg_step = 0      # svrg_step
launches_mix_prox = 0       # mix_prox

# the reference's flat-buffer tile: flatten_tree pads to whole (8, 1024)
# tiles so that its buffers equal the reference's element by element
BLOCK_ROWS = 8
BLOCK_COLS = 1024

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


def _check_selectors(streams, rule: str, prox_kind: str):
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


def _check_tensors(tensors, like):
    for t in tensors:
        if t.device != like.device:
            raise ValueError(f"operands on {t.device} and {like.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")


def _check_cuda_operands(w, streams, alpha, rule: str, prox_kind: str):
    _check_selectors(streams, rule, prox_kind)
    x = streams[0]
    if x.ndim != 2:
        raise ValueError(f"streams must be (m, d), got {tuple(x.shape)}")
    m, d = x.shape
    tensors = list(streams) + [w]
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError("alpha must be a scalar")
        tensors.append(alpha)
    _check_tensors(tensors, x)
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


def _check_cells_operands(w, streams, alpha, lam, rule: str,
                          prox_kind: str):
    _check_selectors(streams, rule, prox_kind)
    x = streams[0]
    if x.ndim != 3:
        raise ValueError(f"cell streams must be (B, m, d), got "
                         f"{tuple(x.shape)}")
    cells, m, d = x.shape
    tensors = list(streams) + [w]
    for name, v in (("alpha", alpha), ("lam", lam)):
        if isinstance(v, torch.Tensor):
            if v.numel() not in (1, cells):
                raise ValueError(f"{name} must hold 1 or {cells} values, "
                                 f"got {v.numel()}")
            tensors.append(v)
    _check_tensors(tensors, x)
    for s in streams:
        if tuple(s.shape) != (cells, m, d):
            raise ValueError(f"stream shape {tuple(s.shape)} != "
                             f"{(cells, m, d)}")
    if tuple(w.shape) not in ((cells, m, m), (m, m)):
        raise ValueError(f"mixing matrices {tuple(w.shape)}: want "
                         f"{(cells, m, m)} or {(m, m)}")
    if m > kernel.max_m():
        raise ValueError(f"the fused kernel takes at most {kernel.max_m()} "
                         f"nodes, got m={m}")
    if not 1 <= cells <= 65535:
        raise ValueError(f"the fused kernel takes 1 to 65535 cells, got "
                         f"{cells}")


def fused_step_cells_buf(w, streams, alpha, lam, *, rule: str = "svrg",
                         prox_kind: str = "l1"):
    """``fused_step_buf`` for the B cells of a sweep in one launch.

    ``streams``: (B, m, d) contiguous float32, as for ``fused_step_buf``;
    ``w``: (B, m, m), one mixing matrix a cell, or (m, m), shared;
    ``alpha`` and ``lam``: each a Python float, a one-element float32
    tensor (shared) or a (B,) float32 tensor (one a cell), on the buffers'
    device.  Each cell gets the bits of a single-cell call.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (one count);
    any other device raises.
    """
    global launches_cells
    streams = tuple(streams)
    device = streams[0].device
    if device.type == "cpu":
        return ref.fused_step_cells_math(w, streams, alpha, lam, rule=rule,
                                         prox_kind=prox_kind)
    if device.type != "cuda":
        raise ValueError(f"the fused step runs on CUDA (kernel) or CPU "
                         f"(plain version), not on {device}")
    _check_cells_operands(w, streams, alpha, lam, rule, prox_kind)
    out = torch.empty_like(streams[0])
    rc = kernel.fused_step_cells_launch(w, streams, out, alpha, lam,
                                        rule=rule, prox_kind=prox_kind)
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch over {out.shape[0]} "
                           f"cells failed with status {rc}")
    launches_cells += 1
    return out


class _FusedStep(torch.autograd.Function):
    """``fused_step_buf`` as a function that ``torch.func.vmap`` can batch:
    under a vmap over cells its rule calls ``fused_step_cells_buf`` once
    for all of them.  No gradient flows through the step."""

    @staticmethod
    def forward(w, alpha, lam, rule, prox_kind, *streams):
        return fused_step_buf(w, streams, alpha, lam, rule=rule,
                              prox_kind=prox_kind)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, w, alpha, lam, rule, prox_kind, *streams):
        cells = info.batch_size

        def cell_axis(t, dim, expand):
            if dim is not None:
                return t.movedim(dim, 0).contiguous()
            return t.expand(cells, *t.shape).contiguous() if expand else t

        w_dim, alpha_dim, lam_dim = in_dims[:3]
        streams = [cell_axis(s, dim, True)
                   for s, dim in zip(streams, in_dims[5:])]
        out = fused_step_cells_buf(
            cell_axis(w, w_dim, False), streams,
            cell_axis(alpha, alpha_dim, False), cell_axis(lam, lam_dim, False),
            rule=rule, prox_kind=prox_kind)
        return out, 0


def fused_resident_step(w, x_tree, grad_trees, alpha, lam, *, rule: str,
                        prox_kind: str):
    """Tree-level fused step: prox(W @ (x - alpha*v)).

    ``w``: dense (m, m) float32 mixing matrix on the parameters' device.
    ``grad_trees``: (g_now, g_snap, mu) for rule="svrg", (g,) for "sgd" —
    all with the stacked (m, ...) structure of ``x_tree``.  ``alpha`` and
    ``lam``: Python floats or 0-d float32 tensors.  Under ``torch.func.vmap``
    over the cells of a sweep, one cell-batched launch serves every cell.
    """
    m = pytree.tree_leaves(x_tree)[0].shape[0]
    x_buf, aux = flatten_stacked(x_tree, m)
    streams = [x_buf] + [flatten_stacked(t, m)[0] for t in grad_trees]
    out = _FusedStep.apply(w.contiguous(), alpha, lam, rule, prox_kind,
                           *streams)
    return unflatten_stacked(out, aux)


# ---------------------------------------------------------------------------
# The elementwise pipeline: svrg_step and mix_prox over flat buffers
# ---------------------------------------------------------------------------

def flatten_tree(tree):
    """-> (buffer (rows, 1024) float32, aux): every leaf flattened and
    concatenated, zero-padded to whole (8, 1024) tiles, as the reference's
    ``flatten_tree`` lays it out."""
    leaves, spec = pytree.tree_flatten(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    n = flat.shape[0]
    padded = -n % (BLOCK_ROWS * BLOCK_COLS)
    if padded:
        flat = torch.cat([flat, flat.new_zeros(padded)])
    shapes = [tuple(leaf.shape) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    return flat.reshape(-1, BLOCK_COLS), (spec, shapes, dtypes, n)


def unflatten_tree(buf, aux):
    spec, shapes, dtypes, n = aux
    flat = buf.reshape(-1)[:n]
    leaves, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        size = int(np.prod(shp, dtype=np.int64))
        leaves.append(flat[off:off + size].reshape(shp).to(dt))
        off += size
    return pytree.tree_unflatten(leaves, spec)


def _check_elementwise(name: str, operands, alpha=None) -> None:
    """Same device, float32, contiguous, one shape; alpha a Python number or
    a one-element float32 tensor on the operands' device."""
    first = operands[0]
    for t in operands:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous tensors")
        if t.shape != first.shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(first.shape)} differ")
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError(f"{name}: alpha must be a scalar")
        if alpha.device != first.device or alpha.dtype != torch.float32:
            raise ValueError(f"{name}: a tensor alpha must be float32 on "
                             f"{first.device}")


def _route(name: str, device: torch.device) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); any other device raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                         f"version), not on {device}")
    return True


def svrg_step(x, g_now, g_snap, mu, alpha):
    """q = x - alpha * (g_now - g_snap + mu) over float32 buffers of one
    shape.  ``alpha``: a Python float or a one-element float32 tensor on
    the buffers' device.  CPU tensors run the plain version; CUDA tensors
    launch the kernel; any other device raises."""
    global launches_svrg_step
    if not _route("svrg_step", x.device):
        return ref.svrg_step_ref(x, g_now, g_snap, mu, alpha)
    _check_elementwise("svrg_step", (x, g_now, g_snap, mu), alpha)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = kernel.svrg_step_launch(x, g_now, g_snap, mu, out, alpha)
    if rc != 0:
        raise RuntimeError(f"svrg_step kernel launch failed with status {rc}")
    launches_svrg_step += 1
    return out


def _mix_prox_weights(weights, device: torch.device):
    """The four scalars of a mix_prox launch: Python floats as they are;
    if any is a tensor (a one-element float32 tensor on ``device``), all
    four as one (4,) float32 tensor on ``device``, which the kernel reads
    from device memory (no copy to the host)."""
    if not any(isinstance(v, torch.Tensor) for v in weights):
        return weights
    for v in weights:
        if isinstance(v, torch.Tensor) and (
                v.numel() != 1 or v.device != device
                or v.dtype != torch.float32):
            raise ValueError(f"mix_prox: a tensor weight must be a float32 "
                             f"scalar on {device}")
    return torch.stack([
        v.reshape(()) if isinstance(v, torch.Tensor)
        else torch.full((), v, dtype=torch.float32, device=device)
        for v in weights])


def mix_prox(q_self, q_up, q_down, w_self, w_up, w_down, thresh):
    """soft_threshold(w_self*q_self + w_up*q_up + w_down*q_down, thresh)
    over float32 buffers of one shape; the weights and the threshold are
    each a Python float or a one-element float32 tensor on the buffers'
    device (then read from device memory: a step whose weights come from
    staged tensors launches without a sync).  CPU tensors run the plain
    version; CUDA tensors launch the kernel; any other device raises."""
    global launches_mix_prox
    if not _route("mix_prox", q_self.device):
        return ref.mix_prox_ref(q_self, q_up, q_down, w_self, w_up, w_down,
                                thresh)
    _check_elementwise("mix_prox", (q_self, q_up, q_down))
    weights = _mix_prox_weights((w_self, w_up, w_down, thresh),
                                q_self.device)
    out = torch.empty_like(q_self)
    if out.numel() == 0:
        return out
    rc = kernel.mix_prox_launch(q_self, q_up, q_down, out, weights)
    if rc != 0:
        raise RuntimeError(f"mix_prox kernel launch failed with status {rc}")
    launches_mix_prox += 1
    return out
