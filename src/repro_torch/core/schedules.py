"""Step-count and learning-rate schedules.

* ``inner_loop_lengths`` — the paper's geometric inner-loop growth
  ``K_s = ceil(beta^s * n0)`` (Algorithm 1 line 4).
* ``dspg_stepsize`` — the O(1/sqrt(k)) decaying step DSPG needs for
  convergence (the paper's baseline [11]).
* ``wsd`` — Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395) used by the
  minicpm-2b architecture config.
* plus constant / cosine / linear-warmup standards for the LM trainer.

A copy of ``repro.core.schedules`` (numpy only), kept in the port so that it never
imports JAX; the parity tests hold the two bitwise equal.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = [
    "inner_loop_lengths",
    "total_inner_steps",
    "dspg_stepsize",
    "constant",
    "cosine",
    "warmup_cosine",
    "wsd",
]


def inner_loop_lengths(beta: float, n0: int, num_outer: int) -> list[int]:
    """K_s = ceil(beta^s * n0) for s = 1..num_outer."""
    return [int(math.ceil((beta ** s) * n0)) for s in range(1, num_outer + 1)]


def total_inner_steps(beta: float, n0: int, num_outer: int) -> int:
    return sum(inner_loop_lengths(beta, n0, num_outer))


def dspg_stepsize(alpha0: float, decay: float = 0.5) -> Callable[[int], float]:
    """alpha_k = alpha0 / (k+1)^decay — the classic decaying step for
    decentralized stochastic proximal gradient (O(1/sqrt(T)) regime)."""
    def fn(k: int):
        return alpha0 / float((k + 1) ** decay)
    return fn


def constant(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def cosine(lr: float, total_steps: int, final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int):
        t = min(step, total_steps) / max(total_steps, 1)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: int):
        if step < warmup:
            return lr * (step + 1) / warmup
        return cos(step - warmup)
    return fn


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01) -> Callable[[int], float]:
    """Warmup-Stable-Decay: linear warmup, long constant plateau, short
    exponential-style decay tail (MiniCPM Sec. 4)."""
    def fn(step: int):
        if step < warmup:
            return lr * (step + 1) / warmup
        if step < warmup + stable:
            return lr
        t = min(step - warmup - stable, decay) / max(decay, 1)
        return lr * (final_frac ** t)
    return fn
