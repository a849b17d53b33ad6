"""Plain PyTorch versions of the fused-update kernels.

``svrg_step_ref`` / ``mix_prox_ref`` / ``inner_step_ref`` are the ports of
``repro.kernels.fused_update.ref``'s elementwise pipeline and the oracles of
the CUDA kernels in ``csrc/svrg_mix.cu``; ``fused_step_math`` is the port of
the reference's ``fused_step_math`` and the oracle of ``csrc/fused_step.cu``,
and ``fused_step_cells_math`` (the same step for every cell of a sweep, the
reference's ``vmap`` of it) the oracle of its cell-batched launch.
The wrappers in ``ops`` run them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the kernels against them on the card.

Scalars that are Python floats are rounded to float32 before they touch a
tensor, and every product and sum is its own float32 operation, in the
kernels' order: the CUDA kernels, which contract nothing into FMAs, then
give the same bits.  The fused step's buffers are the port's own layout:
contiguous row-major ``(m, d)`` float32, one row per node, no padding.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["svrg_step_ref", "mix_prox_ref", "inner_step_ref",
           "fused_step_math", "fused_step_ref", "fused_step_cells_math",
           "FUSED_RULES", "FUSED_PROXES"]

# static configuration space of the fused resident step
FUSED_RULES = ("svrg", "sgd")
FUSED_PROXES = ("l1", "sql2", "none")


def _f32(a):
    """A Python scalar rounded to float32 (as the kernels receive it); a
    tensor as a float32 tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return float(np.float32(a))


def svrg_step_ref(x, g_now, g_snap, mu, alpha):
    """q = x - alpha * (g_now - g_snap + mu)   (Algorithm 1 lines 8-9)."""
    v = g_now - g_snap + mu
    return x - _f32(alpha) * v


def mix_prox_ref(q_self, q_up, q_down, w_self, w_up, w_down, thresh):
    """soft_threshold(w_self*q_self + w_up*q_up + w_down*q_down, thresh)

    (ring-gossip combine + l1 prox; Algorithm 1 lines 10-11 with threshold
    = alpha * lambda)."""
    z = (_f32(w_self) * q_self + _f32(w_up) * q_up) + _f32(w_down) * q_down
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - _f32(thresh), 0.0)


def inner_step_ref(x, g_now, g_snap, mu, x_up, x_down, w_self, w_up, w_down,
                   alpha, thresh):
    """Single-device composition of the two: the neighbours' q are supplied
    already exchanged."""
    q = svrg_step_ref(x, g_now, g_snap, mu, alpha)
    return mix_prox_ref(q, x_up, x_down, w_self, w_up, w_down, thresh)


def fused_step_math(w, streams, alpha, lam, *, rule: str, prox_kind: str):
    """One resident inner step over stacked (m, d) float32 buffers.

        v   = g_now - g_snap + mu        (rule="svrg"; 4 streams)
              g                          (rule="sgd";  2 streams)
        q   = x - alpha * v
        z   = W @ q                      (gossip mix over the node axis)
        out = prox(z, alpha, lam)        (l1 soft-threshold | sql2 | none)

    ``w`` is the (m, m) mixing matrix.  ``alpha`` and ``lam`` are each a
    0-d float32 tensor or a Python float; both are rounded to float32, so
    the threshold ``alpha * lam`` is a float32 product as in the kernel.
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
    alpha, lam = _f32(alpha), _f32(lam)
    if isinstance(alpha, torch.Tensor) or isinstance(lam, torch.Tensor):
        t = alpha * lam        # one float32 product
    else:
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


def fused_step_cells_math(w, streams, alpha, lam, *, rule: str,
                          prox_kind: str):
    """``fused_step_math`` for every cell of a sweep: streams (B, m, d); ``w``
    (B, m, m), one matrix a cell, or (m, m), shared; ``alpha`` and ``lam``
    each a Python float, a 0-d tensor (shared) or a (B,) tensor (one a
    cell).  Cell by cell, so each cell's result is the single-cell one."""
    cells = streams[0].shape[0]

    def pick(v, b):
        if isinstance(v, torch.Tensor) and v.ndim > 0:
            return v.reshape(-1)[b] if v.numel() == cells else v.reshape(())
        return v

    return torch.stack([
        fused_step_math(w[b] if w.ndim == 3 else w,
                        [s[b] for s in streams], pick(alpha, b),
                        pick(lam, b), rule=rule, prox_kind=prox_kind)
        for b in range(cells)])
