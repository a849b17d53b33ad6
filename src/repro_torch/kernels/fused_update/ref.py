"""Plain PyTorch version of the fused resident step.

``fused_step_math`` is the port of ``repro.kernels.fused_update.ref.
fused_step_math`` and the oracle of the CUDA kernel in ``csrc/fused_step.cu``:
the kernel's wrapper (``ops.fused_step_buf``) runs it for tensors on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it on the
card.  Buffers are the port's own layout: contiguous row-major ``(m, d)``
float32, one row per node, no padding.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fused_step_math", "fused_step_ref", "FUSED_RULES",
           "FUSED_PROXES"]

# static configuration space of the fused resident step
FUSED_RULES = ("svrg", "sgd")
FUSED_PROXES = ("l1", "sql2", "none")


def fused_step_math(w, streams, alpha, lam, *, rule: str, prox_kind: str):
    """One resident inner step over stacked (m, d) float32 buffers.

        v   = g_now - g_snap + mu        (rule="svrg"; 4 streams)
              g                          (rule="sgd";  2 streams)
        q   = x - alpha * v
        z   = W @ q                      (gossip mix over the node axis)
        out = prox(z, alpha, lam)        (l1 soft-threshold | sql2 | none)

    ``w`` is the (m, m) mixing matrix.  ``alpha`` is a 0-d float32 tensor
    or a Python float, ``lam`` a Python float; both are rounded to float32,
    so the threshold ``alpha * lam`` is a float32 product as in the kernel.
    No scalar is copied to the device.
    """
    if rule == "svrg":
        x, g_now, g_snap, mu = streams
        v = g_now - g_snap + mu
    elif rule == "sgd":
        x, g_now = streams
        v = g_now
    else:
        raise ValueError(f"unknown fused rule {rule!r}; have {FUSED_RULES}")
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(torch.float32)
        t = alpha * lam        # float32 product: lam is rounded to float32
    else:
        alpha = float(np.float32(alpha))
        t = float(np.float32(alpha) * np.float32(lam))
    q = x - alpha * v
    z = w @ q
    if prox_kind == "l1":
        return torch.sign(z) * torch.clamp_min(torch.abs(z) - t, 0.0)
    if prox_kind == "sql2":
        return z / (1.0 + t)
    if prox_kind == "none":
        return z
    raise ValueError(
        f"unknown fused prox kind {prox_kind!r}; have {FUSED_PROXES}")


def fused_step_ref(w, streams, alpha, lam, *, rule: str = "svrg",
                   prox_kind: str = "l1"):
    """Whole-buffer oracle with the reference's default rule and prox."""
    return fused_step_math(w, streams, alpha, lam, rule=rule,
                           prox_kind=prox_kind)
