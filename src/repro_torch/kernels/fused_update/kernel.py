"""Binding of the fused resident-step CUDA kernel (``csrc/fused_step.cu``).

The kernel is the Hopper counterpart of the Pallas TPU kernel
``repro.kernels.fused_update.kernel.fused_step_kernel_call``; the source's
header says what bounds it and how it is laid out.  It is compiled with
``nvcc`` for ``sm_90a`` on first use (``kernels._build``) and called through
``ctypes`` on PyTorch's current stream.  This module only launches: the
checks on device, type, shape and contiguity, and the launch count, live in
the wrapper ``ops.fused_step_buf``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

__all__ = ["SOURCE", "RULES", "PROXES", "library", "max_m",
           "fused_step_launch"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"

# the C entry point's int selectors
RULES = {"svrg": 0, "sgd": 1}
PROXES = {"l1": 0, "sql2": 1, "none": 2}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr = ctypes.c_void_p
    lib.fused_step_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,          # w, x, g0, g1, g2, out
        ctypes.c_int, ctypes.c_longlong,       # m, d
        ptr, ctypes.c_float, ctypes.c_float,   # alpha_ptr, alpha_val, lam
        ctypes.c_int, ctypes.c_int,            # rule, prox
        ptr]                                   # stream
    lib.fused_step_launch.restype = ctypes.c_int
    lib.fused_step_max_m.argtypes = []
    lib.fused_step_max_m.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_m() -> int:
    """The largest node count the kernel takes."""
    return library().fused_step_max_m()


def fused_step_launch(w: torch.Tensor, streams, out: torch.Tensor, alpha,
                      lam: float, *, rule: str, prox_kind: str) -> int:
    """Launch on the current stream of ``out``'s device; returns the C
    entry point's status (0, a CUDA error code, or -1).  ``alpha`` is a
    Python float or a one-element float32 tensor on the same device, read
    by the kernel from device memory."""
    m, d = out.shape
    # x, g0, g1, g2: rule sgd passes null for the two it does not read
    ptrs = [s.data_ptr() for s in streams] + [None] * (4 - len(streams))
    if isinstance(alpha, torch.Tensor):
        alpha_ptr, alpha_val = alpha.data_ptr(), 0.0
    else:
        alpha_ptr, alpha_val = None, float(alpha)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return library().fused_step_launch(
            w.data_ptr(), ptrs[0], ptrs[1], ptrs[2], ptrs[3], out.data_ptr(),
            m, d, alpha_ptr, alpha_val, float(lam), RULES[rule],
            PROXES[prox_kind], stream)
