"""What decides ``correct``: numbers compared with the plain reference,
each beside its limit."""

from __future__ import annotations

import math

import numpy as np


class Checks:
    """Numbers and their limits, in the order they were compared.  A
    number passes when it is finite and at most its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.items = []           # [(name, value, limit)]

    def add(self, name: str, value: float) -> None:
        self.items.append((name, float(value), float(self.limits[name])))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def lines(self) -> list:
        return [f"check {n}: {v!r} (limit {lim!r}) "
                f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}"
                for n, v, lim in self.items]


def relative_gap(got, want, floor: float = 0.0) -> float:
    """max |got - want| / max(|want|, floor), elementwise, as a number."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    den = np.maximum(np.abs(want), floor)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(got - want) / den
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(np.max(gap)) if gap.size else 0.0


def worst_leaf_gap(got_norms: dict, want_norms: dict,
                   keep=None) -> float:
    """The gap of the program's norm of each leaf from the reference's,
    over the larger of that leaf's reference norm and the median leaf's,
    worst over the leaves (``keep``: the names held)."""
    names = sorted(want_norms) if keep is None else sorted(keep)
    if not names:
        return math.inf
    med = float(np.median([want_norms[k] for k in names]))
    worst = 0.0
    for k in names:
        if k not in got_norms:
            return math.inf
        den = max(abs(want_norms[k]), med)
        gap = abs(got_norms[k] - want_norms[k]) / den if den > 0 else (
            0.0 if got_norms[k] == want_norms[k] else math.inf)
        if not math.isfinite(got_norms[k]):
            gap = math.inf
        worst = max(worst, gap)
    return worst
