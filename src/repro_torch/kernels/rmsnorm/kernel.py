"""Binding of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

The kernel is the Hopper counterpart of the Pallas TPU kernel
``repro.kernels.rmsnorm.kernel.rmsnorm_kernel_call``; the source's header
says what bounds it and how it is laid out.  It is compiled with ``nvcc``
for ``sm_90a`` on first use (``kernels._build``) and called through
``ctypes`` on PyTorch's current stream.  This module only launches: the
checks and the launch count live in the wrapper ``ops.rmsnorm``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

__all__ = ["SOURCE", "DTYPES", "library", "max_d", "rmsnorm_launch"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

# the C entry point's dtype selector (x, weight and out share the type)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr = ctypes.c_void_p
    lib.rmsnorm_launch.argtypes = [
        ptr, ptr, ptr,                         # x, w, out
        ctypes.c_longlong, ctypes.c_int,       # rows, d
        ctypes.c_longlong, ctypes.c_float,     # x row stride, eps
        ctypes.c_int, ptr]                     # dtype, stream
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_max_d.argtypes = [ctypes.c_int]
    lib.rmsnorm_max_d.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_d(dtype: torch.dtype) -> int:
    """The widest row the kernel takes (the row lives in shared memory)."""
    return library().rmsnorm_max_d(torch.finfo(dtype).bits // 8)


def rmsnorm_launch(x2: torch.Tensor, weight: torch.Tensor, out: torch.Tensor,
                   eps: float) -> int:
    """Launch on the current stream of ``out``'s device over the rows of the
    2-D view ``x2`` (unit column stride); returns the C entry point's
    status (0, a CUDA error code, or -1).  Enters ``out``'s device only
    when it is not the current one: the common case makes no context
    switch."""
    if out.device.index != torch.cuda.current_device():
        with torch.cuda.device(out.device):
            return rmsnorm_launch(x2, weight, out, eps)
    rows, d = x2.shape
    stream = torch.cuda.current_stream().cuda_stream
    return library().rmsnorm_launch(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
        x2.stride(0), float(eps), DTYPES[x2.dtype], stream)
