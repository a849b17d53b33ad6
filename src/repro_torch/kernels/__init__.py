"""Kernels of the PyTorch port, written by hand for NVIDIA Hopper.

Each kernel package mirrors its counterpart in ``repro.kernels``:

  kernel.py — the binding of the kernel (CUDA C++ under ``csrc/``, built
              with ``nvcc`` on first use by ``_build``);
  ops.py    — the wrapper: layout, checks, device routing, launch count;
  ref.py    — the plain PyTorch version, which runs for CPU tensors and is
              the kernel's oracle on the card.

  fused_update — the fused resident step prox(W @ (x - alpha*v)) of
                 DPSVRG / DSPG (replaces the Pallas fused_step_kernel_call).
"""

from . import fused_update

__all__ = ["fused_update"]
