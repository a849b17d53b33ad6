"""Wrapper of the flash attention forward kernel: layout, checks, device
routing and the launch count.

``flash_attention`` is the one entry to the kernel and takes the model's
(B, S, H, hd) layout, as the JAX package's wrapper does.  For tensors on
the CPU it runs the plain PyTorch version (``ref.attention_ref``); for CUDA
tensors it checks them, launches the CUDA kernel and adds one to
``launches``, or raises.  There is no fallback from the kernel to the plain
version.  The kernel masks ragged sequence lengths and head dims itself, so
the reference wrapper's padding and scale correction (and its refusal of a
ragged bidirectional Sk) have no counterpart here.
"""

from __future__ import annotations

import torch

from . import kernel, ref

__all__ = ["flash_attention", "launches"]

# Launches of the CUDA kernel since the count was last set to 0: one per
# kernel launch, counted by flash_attention and nowhere else.
launches = 0


def _check_cuda_operands(q, k, v, sliding_window, softcap):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, heads, hd) tensors")
    b, sq, h, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    kv = k.shape[2]
    if kv < 1 or h % kv != 0:
        raise ValueError(f"{h} query heads do not split into {kv} kv heads")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype} but k or v is {t.dtype}")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("the flash kernel takes contiguous tensors")
    if hd > kernel.max_head_dim():
        raise ValueError(f"the flash kernel takes head_dim up to "
                         f"{kernel.max_head_dim()}, got {hd}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: int | None = None,
                    softcap: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  CPU
    tensors run the plain version; CUDA tensors launch the kernel; any other
    device raises."""
    global launches
    if q.device.type == "cpu":
        out = ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, sliding_window=sliding_window, softcap=softcap)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA (kernel) or CPU "
                         f"(plain version), not on {q.device}")
    _check_cuda_operands(q, k, v, sliding_window, softcap)
    out = torch.empty_like(q)
    rc = kernel.flash_attention_launch(q, k, v, out, causal=causal,
                                       sliding_window=sliding_window,
                                       softcap=softcap)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed with "
                           f"status {rc}")
    launches += 1
    return out
