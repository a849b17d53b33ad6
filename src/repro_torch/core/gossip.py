"""Consensus (gossip) primitives over stacked node parameters: the port of
``repro.core.gossip`` on one device.

Two wire formats, usable anywhere a ``phi`` is accepted (``mix_stacked``
dispatches on type):

* a dense ``(m, m)`` matrix, applied as one matrix product over the leading
  node axis.  The k-round multi-consensus product is formed on the host
  (``multi_consensus_matrix``), so any number of gossip rounds costs one
  product on the device;
* :class:`BandedPhi`, the matrix in cyclic-band form: each nonzero band is
  one ``torch.roll`` of the stacked buffer, so ring schedules (degree <= 2)
  mix in O(degree) passes.

The reference's third format, ``PermutePhi`` (one collective-permute per
band on a device mesh), is multi-device work (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import graphs

__all__ = [
    "mark_stateful",
    "mix_stacked",
    "multi_consensus_matrix",
    "band_decompose",
    "banded_to_dense",
    "schedule_band_offsets",
    "bands_for_phi",
    "BandedPhi",
    "mix_stacked_banded",
    "stack_tree",
    "unstack_tree",
    "node_mean",
]


def stack_tree(tree, m: int):
    """Replicate a tree along a new leading node axis of size m."""
    return pytree.tree_map(lambda x: x[None].expand((m,) + x.shape), tree)


def unstack_tree(tree, i: int = 0):
    """Node ``i``'s parameters of a stacked tree."""
    return pytree.tree_map(lambda x: x[i], tree)


def node_mean(tree):
    return pytree.tree_map(lambda x: x.mean(dim=0), tree)


def as_mix_tensor(phi, like: torch.Tensor) -> torch.Tensor:
    """A dense phi (numpy or tensor) as a float32 tensor on ``like``'s
    device."""
    if isinstance(phi, torch.Tensor):
        return phi.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(phi), dtype=torch.float32,
                           device=like.device)


# Phi types whose mix needs a threaded transport state (error feedback,
# delay buffers): the stateless mix_stacked refuses them.  The compression
# and scenario modules register theirs with mark_stateful, so an algorithm
# that mixes without a state (DSPG, DPG) fails loudly instead of dropping
# the state's semantics.
_STATEFUL_ONLY: tuple = ()


def mark_stateful(phi_type: type) -> None:
    """Register a phi type as stateful-only (see ``_STATEFUL_ONLY``)."""
    global _STATEFUL_ONLY
    if phi_type not in _STATEFUL_ONLY:
        _STATEFUL_ONLY = _STATEFUL_ONLY + (phi_type,)


def mix_stacked(phi, tree):
    """One consensus application: leaf <- phi @ leaf over the node axis.

    ``phi`` is a dense (m, m) matrix, numpy or tensor — typically the
    host-side multi-consensus product, so k-round gossip is one product — or
    a :class:`BandedPhi`, dispatched to :func:`mix_stacked_banded`.  A
    stateful-only phi (compressed gossip, the scenario pipeline) raises: it
    needs ``compression.mix_with_state``.
    """
    if _STATEFUL_ONLY and isinstance(phi, _STATEFUL_ONLY):
        raise TypeError(
            f"{type(phi).__name__} mixing is stateful (error feedback / "
            f"delay buffers) and cannot run through the stateless "
            f"gossip.mix_stacked: the driven algorithm must route mixing "
            f"through compression.mix_with_state and thread a mix state "
            f"(Algorithm.init_mix_state); dspg/dpg support stateless "
            f"transports only")
    if isinstance(phi, BandedPhi):
        return mix_stacked_banded(phi.offsets, phi.coeffs, tree)

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


@functools.lru_cache(maxsize=64)
def _band_index(offsets: tuple, m: int, device: torch.device):
    """Flat indices i * m + (i + d) % m of every (band, node) entry, made
    once per offset set and device, so that a lowering on the card copies
    nothing from the host."""
    rows = np.arange(m)
    idx = np.concatenate([rows * m + (rows + d) % m for d in offsets])
    return torch.as_tensor(idx, device=device)


def banded_to_dense(offsets: tuple, coeffs) -> torch.Tensor:
    """Inverse of :func:`band_decompose`: (offsets, coeffs (n_bands, m)) ->
    dense float32 (m, m) with W[i, (i + d) % m] = coeffs[b][i], on the
    coefficients' device (numpy coefficients give a CPU tensor).  This is
    how a banded phi reaches the fused resident-step kernel's mix matrix:
    one scatter of all bands, two launches on the card."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32)
    m = coeffs.shape[-1]
    offsets = tuple(int(d) for d in offsets)
    idx = _band_index(offsets, m, coeffs.device)
    w = torch.zeros(m * m, dtype=torch.float32, device=coeffs.device)
    # offsets that meet mod m add up, as the reference's .at[].add does
    distinct = len({d % m for d in offsets}) == len(offsets)
    w.index_put_((idx,), coeffs.reshape(-1), accumulate=not distinct)
    return w.reshape(m, m)


def bands_for_phi(phi: np.ndarray, offsets: tuple) -> np.ndarray:
    """Coefficients (len(offsets), m) of phi on a FIXED offset set (zeros for
    absent bands).  Raises if phi has mass outside the offset set."""
    m = phi.shape[0]
    full_off, full_c = band_decompose(phi)
    missing = set(full_off) - set(offsets)
    if missing:
        raise ValueError(f"phi has bands {sorted(missing)} outside {offsets}")
    out = np.zeros((len(offsets), m), np.float32)
    idx = {d: i for i, d in enumerate(offsets)}
    for d, c in zip(full_off, full_c):
        out[idx[d]] = c
    return out


class BandedPhi:
    """A mixing matrix in cyclic-band form, usable anywhere a dense phi is.

    ``offsets`` is the static band-offset set (the pytree context, so it
    rides along when the runner stages or slices the coefficients);
    ``coeffs`` holds the per-band coefficients, ``(n_bands, m)`` for one
    step or ``(T, n_bands, m)`` when a resident chunk stacks T steps.
    Numpy on the host, a tensor once staged on the device.
    """

    __slots__ = ("offsets", "coeffs")

    def __init__(self, offsets: tuple, coeffs):
        self.offsets = tuple(offsets)
        self.coeffs = coeffs

    @classmethod
    def from_dense(cls, phi: np.ndarray, offsets: tuple) -> "BandedPhi":
        """Project a dense phi onto a fixed offset set (raises on leakage)."""
        return cls(offsets, bands_for_phi(np.asarray(phi), offsets))

    def __repr__(self):
        shape = getattr(self.coeffs, "shape", None)
        return f"BandedPhi(offsets={self.offsets}, coeffs.shape={shape})"


pytree.register_pytree_node(
    BandedPhi,
    lambda phi: ([phi.coeffs], phi.offsets),
    lambda children, offsets: BandedPhi(offsets, list(children)[0]))


def mix_stacked_banded(offsets: tuple, coeffs, tree):
    """Gossip via cyclic-shift bands: leaf <- sum_b c_b * roll(leaf, -d_b)
    over the node axis.  coeffs: (len(offsets), m)."""
    def _mix(leaf):
        c_all = as_mix_tensor(coeffs, leaf).to(leaf.dtype)
        out = None
        for b, d in enumerate(offsets):
            shifted = torch.roll(leaf, -d, dims=0) if d else leaf
            c = c_all[b].reshape((leaf.shape[0],) + (1,) * (leaf.ndim - 1))
            term = c * shifted
            out = term if out is None else out + term
        return out

    return pytree.tree_map(_mix, tree)
