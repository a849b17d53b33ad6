"""Proximal operators for non-smooth regularizers (paper Section III-C).

Each operator implements

    prox_h^alpha(z) = argmin_y  (1/(2 alpha)) ||y - z||^2 + h(y)

as a closed-form torch function, together with the regularizer value ``h``
so that training loops can report the full composite objective F = f + h.

The port of ``repro.core.prox``: the same registry, the same formulas.
``alpha`` may be a Python float or a 0-d float32 tensor (the resident
runner keeps its step sizes on the device).  The weights of ``l1``,
``squared_l2`` and ``elastic_net`` may be Python floats or float32 tensors:
a batched sweep rebuilds each cell's prox from that cell's 0-d value under
``torch.func.vmap``.  Thresholds such as ``alpha * lam`` are formed as one
float32 product either way, as the reference forms them, so coordinates
that sit at the l1 threshold land on the same side in a batched sweep and
in a run of one cell.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "Prox",
    "l1",
    "squared_l2",
    "elastic_net",
    "group_lasso",
    "nuclear",
    "box",
    "none",
    "get_prox",
    "PROX_REGISTRY",
]


@dataclasses.dataclass(frozen=True)
class Prox:
    """A proximal operator + its regularizer value.

    ``apply(tree, alpha)``: leaf-wise prox with step ``alpha``.
    ``value(tree)``: h(tree) summed over leaves (0-d tensor).
    ``subgrad(tree)``: a canonical element of the subdifferential at
    ``tree``, or ``None`` when no closed form is registered.
    ``fused_spec``: ``(kind, lam)`` with ``kind`` one of the fused
    resident-step kernel's prox kinds
    (``kernels.fused_update.ref.FUSED_PROXES``), or ``None`` when this
    operator has no fused lowering (``kernel="fused"`` then keeps the
    unfused step).
    """

    name: str
    apply: Callable
    value: Callable
    subgrad: Callable | None = None
    fused_spec: tuple | None = dataclasses.field(default=None, compare=False)

    def __call__(self, tree, alpha):
        return self.apply(tree, alpha)


def _f32(v):
    return v if isinstance(v, torch.Tensor) else float(np.float32(v))


def f32_product(a, b):
    """``a * b`` rounded as a float32 product: ``np.float32(a) *
    np.float32(b)`` for Python numbers, and the same bits when either is a
    float32 tensor (a number is rounded to float32 before it multiplies)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return _f32(a) * _f32(b)
    return float(np.float32(a) * np.float32(b))


def _label(v) -> str:
    """A weight in a prox's name: a tensor (a sweep cell's traced value,
    which cannot be printed under vmap) reads as ``cell``."""
    return "cell" if isinstance(v, torch.Tensor) else f"{v}"


def _treewise(fn):
    def wrapped(tree, *args):
        return pytree.tree_map(lambda leaf: fn(leaf, *args), tree)
    return wrapped


def _treesum(fn):
    def wrapped(tree):
        leaves = pytree.tree_leaves(tree)
        if not leaves:
            return torch.zeros(())
        return sum(fn(leaf) for leaf in leaves)
    return wrapped


def _soft_threshold(z, t):
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - t, 0.0)


# ---------------------------------------------------------------------------
# l1 (the paper's regularizer): soft-thresholding
# ---------------------------------------------------------------------------

def l1(lam) -> Prox:
    def _apply(z, alpha):
        return _soft_threshold(z, f32_product(alpha, lam))

    def _value(leaf):
        return lam * torch.sum(torch.abs(leaf))

    def _subgrad(z):
        return lam * torch.sign(z)

    return Prox(name=f"l1({_label(lam)})", apply=_treewise(_apply),
                value=_treesum(_value), subgrad=_treewise(_subgrad),
                fused_spec=("l1", lam))


def squared_l2(lam) -> Prox:
    """h(x) = (lam/2)||x||^2 — shrinkage (smooth, but prox-able for testing)."""
    def _apply(z, alpha):
        return z / (1.0 + f32_product(alpha, lam))

    def _value(leaf):
        return 0.5 * lam * torch.sum(leaf * leaf)

    return Prox(name=f"sql2({_label(lam)})", apply=_treewise(_apply),
                value=_treesum(_value),
                subgrad=_treewise(lambda z: lam * z),
                fused_spec=("sql2", lam))


def elastic_net(lam1, lam2) -> Prox:
    """h(x) = lam1 ||x||_1 + (lam2/2) ||x||^2."""
    def _apply(z, alpha):
        soft = _soft_threshold(z, f32_product(alpha, lam1))
        return soft / (1.0 + f32_product(alpha, lam2))

    def _value(leaf):
        return (lam1 * torch.sum(torch.abs(leaf))
                + 0.5 * lam2 * torch.sum(leaf * leaf))

    def _subgrad(z):
        return lam1 * torch.sign(z) + lam2 * z

    return Prox(name=f"enet({_label(lam1)},{_label(lam2)})",
                apply=_treewise(_apply),
                value=_treesum(_value), subgrad=_treewise(_subgrad))


def _groups(z):
    return z.reshape(-1, z.shape[-1]) if z.ndim >= 2 else z.reshape(1, -1)


def group_lasso(lam: float) -> Prox:
    """h(x) = lam * sum_g ||x_g||_2 with groups = rows of the trailing 2D view.

    Block soft-thresholding: x_g * max(0, 1 - alpha*lam/||x_g||).
    1-D leaves are treated as a single group.
    """
    def _apply(z, alpha):
        z2 = _groups(z)
        nrm = torch.linalg.vector_norm(z2, dim=-1, keepdim=True)
        scale = torch.clamp_min(
            1.0 - f32_product(alpha, lam) / torch.clamp_min(nrm, 1e-12), 0.0)
        return (z2 * scale).reshape(z.shape)

    def _value(leaf):
        return lam * torch.sum(torch.linalg.vector_norm(_groups(leaf), dim=-1))

    def _subgrad(z):
        z2 = _groups(z)
        nrm = torch.linalg.vector_norm(z2, dim=-1, keepdim=True)
        out = torch.where(nrm > 0, lam * z2 / torch.clamp_min(nrm, 1e-30),
                          torch.zeros_like(z2))
        return out.reshape(z.shape)

    return Prox(name=f"glasso({lam})", apply=_treewise(_apply),
                value=_treesum(_value), subgrad=_treewise(_subgrad))


def nuclear(lam: float) -> Prox:
    """h(X) = lam ||X||_* (trace norm) — SVD soft-threshold on 2-D leaves.

    Leaves with ndim != 2 fall back to l1 (element-wise) to stay well-defined
    on arbitrary trees.
    """
    def _apply_leaf(z, alpha):
        t = f32_product(alpha, lam)
        if z.ndim != 2:
            return _soft_threshold(z, t)
        u, s, vt = torch.linalg.svd(z, full_matrices=False)
        s = torch.clamp_min(s - t, 0.0)
        return (u * s[None, :]) @ vt

    def _value(leaf):
        if leaf.ndim != 2:
            return lam * torch.sum(torch.abs(leaf))
        return lam * torch.sum(torch.linalg.svdvals(leaf))

    return Prox(name=f"nuclear({lam})", apply=_treewise(_apply_leaf),
                value=_treesum(_value))


def box(lo: float, hi: float) -> Prox:
    """Indicator of [lo, hi]^d — projection (h = 0 inside, +inf outside)."""
    def _apply(z, alpha):
        del alpha
        return torch.clamp(z, lo, hi)

    def _value(leaf):
        return torch.zeros((), device=leaf.device)

    return Prox(name=f"box({lo},{hi})", apply=_treewise(_apply),
                value=_treesum(_value),
                subgrad=_treewise(torch.zeros_like))


def none() -> Prox:
    def _apply(z, alpha):
        del alpha
        return z

    def _value(leaf):
        return torch.zeros((), device=leaf.device)

    return Prox(name="none", apply=_treewise(_apply), value=_treesum(_value),
                subgrad=_treewise(torch.zeros_like),
                fused_spec=("none", 0.0))


PROX_REGISTRY = {
    "l1": l1,
    "squared_l2": squared_l2,
    "elastic_net": elastic_net,
    "group_lasso": group_lasso,
    "nuclear": nuclear,
    "box": box,
    "none": lambda: none(),
}


def get_prox(name: str, *args) -> Prox:
    if name not in PROX_REGISTRY:
        raise KeyError(f"unknown prox '{name}'; have {sorted(PROX_REGISTRY)}")
    return PROX_REGISTRY[name](*args)
