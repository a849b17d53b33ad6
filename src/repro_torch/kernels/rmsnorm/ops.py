"""Wrapper of the RMSNorm kernel: layout, checks, device routing and the
launch count.

``rmsnorm`` is the one entry to the kernel.  For tensors on the CPU it runs
the plain PyTorch version (``ref.rmsnorm_ref``); for CUDA tensors it checks
them, launches the CUDA kernel and adds one to ``launches``, or raises.
There is no fallback from the kernel to the plain version.  Rows are taken
as they come: the reference's padding of rows to 8 served the TPU only.
"""

from __future__ import annotations

import torch

from . import kernel, ref

__all__ = ["rmsnorm", "launches"]

# Launches of the CUDA kernel since the count was last set to 0: one per
# kernel launch, counted by rmsnorm and nowhere else.
launches = 0


def _rows_view(x):
    """x (..., d) as a (rows, d) view with unit column stride, or raise."""
    d = x.shape[-1]
    try:
        x2 = x.view(-1, d)
    except RuntimeError:
        raise ValueError("the rmsnorm kernel takes rows with one stride "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")
    if d > 1 and x2.stride(1) != 1:
        raise ValueError("the rmsnorm kernel takes rows with unit column "
                         "stride")
    return x2


def rmsnorm(x, weight, eps: float = 1e-6):
    """x: (..., d) any leading shape; weight: (d,).  Output in x's dtype,
    statistics in float32.  CPU tensors run the plain version; CUDA tensors
    launch the kernel, and raise where autograd would need its backward;
    any other device raises."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA (kernel) or CPU (plain "
                         f"version), not on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        # an output written by the kernel carries no gradient, so autograd
        # would take it for a constant: refuse rather than train wrongly
        raise RuntimeError(
            "the rmsnorm kernel has no backward: an operand requires grad. "
            "Differentiate the plain path (use_fused_norm=False), as the "
            "JAX package's Pallas kernel cannot be differentiated either")
    d = x.shape[-1]
    if weight.device != x.device:
        raise ValueError(f"operands on {weight.device} and {x.device}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"the rmsnorm kernel takes a weight of x's dtype "
                        f"{x.dtype}, got {weight.dtype}")
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != {(d,)}")
    if not weight.is_contiguous():
        raise ValueError("the rmsnorm kernel takes a contiguous weight")
    max_d = kernel.max_d(x.dtype)
    if d > max_d:
        raise ValueError(f"the rmsnorm kernel takes rows of at most {max_d} "
                         f"elements, got {d}")
    x2 = _rows_view(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = kernel.rmsnorm_launch(x2, weight, out, eps)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed with status {rc}")
    launches += 1
    return out
