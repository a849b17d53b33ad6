"""Bindings of the fused-update CUDA kernels.

* ``csrc/fused_step.cu`` — the fused resident step, the Hopper counterpart
  of the Pallas TPU kernel ``repro.kernels.fused_update.kernel.
  fused_step_kernel_call``;
* ``csrc/svrg_mix.cu`` — the elementwise pipeline ``svrg_step`` and
  ``mix_prox``, the counterparts of ``svrg_step_kernel_call`` and
  ``mix_prox_kernel_call``.

Each source's header says what bounds its kernels and how they are laid
out.  They are compiled with ``nvcc`` for ``sm_90a`` on first use
(``kernels._build``) and called through ``ctypes`` on PyTorch's current
stream.  This module only launches: the checks on device, type, shape and
contiguity, and the launch counts, live in the wrappers in ``ops``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

__all__ = ["SOURCE", "SVRG_MIX_SOURCE", "RULES", "PROXES", "library",
           "max_m", "fused_step_launch", "noop_launch", "svrg_mix_library",
           "svrg_step_launch", "mix_prox_launch"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"
SVRG_MIX_SOURCE = Path(__file__).resolve().parent / "csrc" / "svrg_mix.cu"

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
    lib.fused_step_noop_launch.argtypes = [ptr]
    lib.fused_step_noop_launch.restype = ctypes.c_int
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


def noop_launch() -> int:
    """Launch the empty kernel of ``fused_step.cu`` (one block) on the
    current stream: the launch floor that fused_step's time is read
    against.  Returns the C entry point's status."""
    return library().fused_step_noop_launch(
        torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def svrg_mix_library() -> ctypes.CDLL:
    lib = _build.load(SVRG_MIX_SOURCE)
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    lib.svrg_step_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr,               # x, g_now, g_snap, mu, out
        ctypes.c_longlong,                     # n
        ptr, f32,                              # alpha_ptr, alpha_val
        ptr]                                   # stream
    lib.svrg_step_launch.restype = ctypes.c_int
    lib.mix_prox_launch.argtypes = [
        ptr, ptr, ptr, ptr,                    # q_self, q_up, q_down, out
        ctypes.c_longlong,                     # n
        f32, f32, f32, f32,                    # w_self, w_up, w_down, thresh
        ptr]                                   # stream
    lib.mix_prox_launch.restype = ctypes.c_int
    return lib


def svrg_step_launch(x, g_now, g_snap, mu, out, alpha) -> int:
    """Launch svrg_step over ``out.numel()`` elements on the current stream
    of ``out``'s device; returns the C entry point's status.  ``alpha`` is
    a Python float or a one-element float32 tensor on the same device.
    Enters ``out``'s device only when it is not the current one."""
    if out.device.index != torch.cuda.current_device():
        with torch.cuda.device(out.device):
            return svrg_step_launch(x, g_now, g_snap, mu, out, alpha)
    if isinstance(alpha, torch.Tensor):
        alpha_ptr, alpha_val = alpha.data_ptr(), 0.0
    else:
        alpha_ptr, alpha_val = None, float(alpha)
    return svrg_mix_library().svrg_step_launch(
        x.data_ptr(), g_now.data_ptr(), g_snap.data_ptr(), mu.data_ptr(),
        out.data_ptr(), out.numel(), alpha_ptr, alpha_val,
        torch.cuda.current_stream().cuda_stream)


def mix_prox_launch(q_self, q_up, q_down, out, w_self, w_up, w_down,
                    thresh) -> int:
    """Launch mix_prox over ``out.numel()`` elements on the current stream
    of ``out``'s device; returns the C entry point's status.  Enters
    ``out``'s device only when it is not the current one."""
    if out.device.index != torch.cuda.current_device():
        with torch.cuda.device(out.device):
            return mix_prox_launch(q_self, q_up, q_down, out, w_self, w_up,
                                   w_down, thresh)
    return svrg_mix_library().mix_prox_launch(
        q_self.data_ptr(), q_up.data_ptr(), q_down.data_ptr(),
        out.data_ptr(), out.numel(), float(w_self), float(w_up),
        float(w_down), float(thresh),
        torch.cuda.current_stream().cuda_stream)
