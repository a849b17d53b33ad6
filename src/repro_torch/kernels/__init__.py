"""Kernels of the PyTorch port, written by hand for NVIDIA Hopper.

Each kernel package mirrors its counterpart in ``repro.kernels``:

  kernel.py — the binding of the kernel (CUDA C++ under ``csrc/``, built
              with ``nvcc`` on first use by ``_build``);
  ops.py    — the wrapper: layout, checks, device routing, launch count;
  ref.py    — the plain PyTorch version, which runs for CPU tensors and is
              the kernel's oracle on the card.

  fused_update    — the fused resident step prox(W @ (x - alpha*v)) of
                    DPSVRG / DSPG (replaces fused_step_kernel_call).
  rmsnorm         — RMSNorm with float32 statistics (replaces
                    rmsnorm_kernel_call); ModelConfig(use_fused_norm=True).
  flash_attention — online-softmax attention forward with GQA, causal and
                    sliding-window masks and softcap (replaces
                    flash_attention_call); ModelConfig(use_flash=True).
"""

from . import flash_attention, fused_update, rmsnorm

__all__ = ["flash_attention", "fused_update", "rmsnorm", "SOURCES"]

# every CUDA source of the port, for building them all at once
SOURCES = (fused_update.kernel.SOURCE, rmsnorm.kernel.SOURCE,
           flash_attention.kernel.SOURCE)
