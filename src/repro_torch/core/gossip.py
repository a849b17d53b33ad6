"""Consensus (gossip) primitives over stacked node parameters: the dense
subset of ``repro.core.gossip``.

A dense ``(m, m)`` mixing matrix ``phi`` is applied as one matrix product
over the leading node axis.  The k-round multi-consensus product is formed
on the host (``multi_consensus_matrix``), so any number of gossip rounds
costs one product on the device.  The cyclic-band helpers are numpy only:
the transport's ``"auto"`` rule needs them to decide which wire format a
schedule calls for.  The banded and ppermute wire formats themselves are
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import graphs

__all__ = [
    "mix_stacked",
    "multi_consensus_matrix",
    "band_decompose",
    "schedule_band_offsets",
    "stack_tree",
    "node_mean",
]


def stack_tree(tree, m: int):
    """Replicate a tree along a new leading node axis of size m."""
    return pytree.tree_map(lambda x: x[None].expand((m,) + x.shape), tree)


def node_mean(tree):
    return pytree.tree_map(lambda x: x.mean(dim=0), tree)


def as_mix_tensor(phi, like: torch.Tensor) -> torch.Tensor:
    """A dense phi (numpy or tensor) as a float32 tensor on ``like``'s
    device."""
    if isinstance(phi, torch.Tensor):
        return phi.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(phi), dtype=torch.float32,
                           device=like.device)


def mix_stacked(phi, tree):
    """One consensus application: leaf <- phi @ leaf over the node axis.

    ``phi`` is a dense (m, m) matrix, numpy or tensor — typically the
    host-side multi-consensus product, so k-round gossip is one product.
    """
    def _mix(leaf):
        w = as_mix_tensor(phi, leaf).to(leaf.dtype)
        return (w @ leaf.reshape(leaf.shape[0], -1)).reshape(leaf.shape)

    return pytree.tree_map(_mix, tree)


def multi_consensus_matrix(schedule: graphs.MixingSchedule, t0: int, k: int,
                           k_max: int | None = None) -> np.ndarray:
    """Phi for the paper's multi-consensus: ``k`` gossip rounds at inner step
    ``k`` (capped at ``k_max``), using the schedule's time-varying matrices
    starting at slot ``t0``."""
    rounds = k if k_max is None else min(k, k_max)
    return schedule.consensus_rounds(t0, max(rounds, 1))


def band_decompose(w: np.ndarray, tol: float = 1e-12):
    """-> (offsets tuple[int], coeffs (n_bands, m) float32) with
    W = sum_b diag(coeffs[b]) P^{offsets[b]} (P = +1 cyclic shift)."""
    m = w.shape[0]
    offsets, coeffs = [], []
    for d in range(m):
        c = np.array([w[i, (i + d) % m] for i in range(m)], dtype=np.float32)
        if np.abs(c).max() > tol:
            offsets.append(d)
            coeffs.append(c)
    return tuple(offsets), np.stack(coeffs)


def schedule_band_offsets(schedule: graphs.MixingSchedule,
                          rounds: int) -> tuple:
    """Union of band offsets over every `rounds`-product the schedule can
    produce in one period."""
    offs = set()
    for t0 in range(schedule.period):
        o, _ = band_decompose(schedule.consensus_rounds(t0, rounds))
        offs.update(o)
    return tuple(sorted(offs))
