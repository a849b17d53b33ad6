"""Plain PyTorch version of the RMSNorm kernel: the CPU path of
``ops.rmsnorm`` and the kernel's oracle on the card."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x, weight, eps: float = 1e-6):
    """x: (..., d); weight: (d,).  Matches ``models.common.rms_norm``:
    (1 + w) scaling, float32 statistics, output in x's dtype."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.to(torch.float32))
    return out.to(dtype)
