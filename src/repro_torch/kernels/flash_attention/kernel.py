"""Binding of the flash attention forward CUDA kernel
(``csrc/flash_attention.cu``).

The kernel is the Hopper counterpart of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_call``; the source's
header says what bounds it and how it is laid out.  One C entry point
launches one of two kernels by dtype: float32 runs on the CUDA cores,
bf16 on the tensor cores (wgmma), which rounds the probabilities P to bf16
before P V (``ref.bf16_bound`` is the error that allows).  It is compiled with
``nvcc`` for ``sm_90a`` on first use (``kernels._build``) and called through
``ctypes`` on PyTorch's current stream.  This module only launches: the
checks and the launch count live in the wrapper ``ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build

__all__ = ["SOURCE", "DTYPES", "library", "max_head_dim",
           "flash_attention_launch"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# the C entry point's dtype selectors
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr,                    # q, k, v, out
        cint, cint, cint, cint, cint, cint,    # B, H, KV, Sq, Sk, hd
        cint, cint,                            # causal, window (<= 0: none)
        ctypes.c_float, ctypes.c_float,        # softcap (<= 0: none), scale
        cint, ptr]                             # dtype, stream
    lib.flash_attention_launch.restype = cint
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = cint
    return lib


@functools.lru_cache(maxsize=None)
def max_head_dim() -> int:
    return library().flash_attention_max_head_dim()


def flash_attention_launch(q, k, v, out, *, causal: bool,
                           sliding_window: int | None,
                           softcap: float | None) -> int:
    """Launch on the current stream of ``out``'s device; returns the C
    entry point's status (0, a CUDA error code, or -1)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, hd, int(bool(causal)),
            int(sliding_window or 0), float(softcap or 0.0),
            1.0 / math.sqrt(hd), DTYPES[q.dtype], stream)
