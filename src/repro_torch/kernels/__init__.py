"""Kernels of the PyTorch port, written by hand for NVIDIA Hopper.

Each kernel package mirrors its counterpart in ``repro.kernels``:

  kernel.py — the binding of the kernel (CUDA C++ under ``csrc/``, built
              with ``nvcc`` on first use by ``_build``);
  ops.py    — the wrapper: layout, checks, device routing, launch count;
  ref.py    — the plain PyTorch version, which runs for CPU tensors and is
              the kernel's oracle on the card.

  fused_update    — the fused resident step prox(W @ (x - alpha*v)) of
                    DPSVRG / DSPG (replaces fused_step_kernel_call), and
                    the elementwise svrg_step and mix_prox (replace
                    svrg_step_kernel_call and mix_prox_kernel_call).
  rmsnorm         — RMSNorm with float32 statistics (replaces
                    rmsnorm_kernel_call); ModelConfig(use_fused_norm=True).
  flash_attention — online-softmax attention forward with GQA, causal and
                    sliding-window masks and softcap (replaces
                    flash_attention_call); ModelConfig(use_flash=True).
                    float32 runs on the CUDA cores, bf16 on the tensor
                    cores (wgmma), rounding P to bf16 before P V.
"""

from . import flash_attention, fused_update, rmsnorm

__all__ = ["flash_attention", "fused_update", "rmsnorm", "SOURCES",
           "launch_counts", "set_launch_counts"]

# every CUDA source of the port, for building them all at once
SOURCES = (fused_update.kernel.SOURCE, fused_update.kernel.SVRG_MIX_SOURCE,
           rmsnorm.kernel.SOURCE, flash_attention.kernel.SOURCE)

# every wrapper's launch count, as (module, attribute)
_COUNTERS = ((fused_update.ops, "launches"),
             (fused_update.ops, "launches_svrg_step"),
             (fused_update.ops, "launches_mix_prox"),
             (rmsnorm.ops, "launches"),
             (flash_attention.ops, "launches"))


def launch_counts() -> tuple:
    """Every wrapper's launch count, in a fixed order."""
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def set_launch_counts(counts) -> None:
    """Set every wrapper's launch count (the order of ``launch_counts``).
    A replayed CUDA graph runs no wrapper, so whoever replays one adds the
    launches it captured."""
    for (mod, name), value in zip(_COUNTERS, counts):
        setattr(mod, name, value)
