"""Consensus (gossip) primitives over stacked node parameters: the port of
``repro.core.gossip``.

Wire formats, usable anywhere a ``phi`` is accepted (``mix_stacked``
dispatches on type):

* a dense ``(m, m)`` matrix, applied as one matrix product over the leading
  node axis.  The k-round multi-consensus product is formed on the host
  (``multi_consensus_matrix``), so any number of gossip rounds costs one
  product on the device;
* :class:`BandedPhi`, the matrix in cyclic-band form: each nonzero band is
  one ``torch.roll`` of the stacked buffer, so ring schedules (degree <= 2)
  mix in O(degree) passes;
* :class:`PermutePhi`, the banded form over a node axis of ranks, one node
  a rank: each band is one point-to-point exchange of the rank's row
  (``spmd.shift``, the reference's ``lax.ppermute``), so the stacked buffer
  is never gathered;
* :class:`GatheredPhi`, a dense or banded phi over node-sharded state
  (``shard="nodes"``): the rows are all-gathered and the rank's rows of the
  mix applied, what GSPMD inserts for the reference's einsum.

The two sharded formats take the leaves' rows of this rank and keep the
whole phi (its coefficients are a few floats a step, replicated as the
reference replicates them).
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import graphs, spmd

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
    "PermutePhi",
    "mix_stacked_permute",
    "GatheredPhi",
    "mix_stacked_gathered",
    "shard_phi",
    "phi_node_axis",
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
    if isinstance(phi, PermutePhi):
        return mix_stacked_permute(phi, tree)
    if isinstance(phi, GatheredPhi):
        return mix_stacked_gathered(phi, tree)

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


# ---------------------------------------------------------------------------
# Node-sharded wire formats: each rank holds its rows of the node axis
# ---------------------------------------------------------------------------

def _coeff(coeffs: torch.Tensor, b: int, i, leaf: torch.Tensor):
    """Band ``b``'s coefficient(s) at node(s) ``i`` (an int or a slice) of
    the float32 ``coeffs`` (``as_mix_tensor``), shaped to multiply
    ``leaf``'s rows."""
    c = coeffs[b][i].to(leaf.dtype)
    return c.reshape(c.shape + (1,) * (leaf.ndim - c.ndim))


class PermutePhi:
    """A banded mixing matrix lowered to point-to-point exchanges over a
    node axis of ranks, one node a rank.

    Same band parameterization as :class:`BandedPhi` (static ``offsets``,
    per-band ``coeffs`` of shape ``(n_bands, m)`` for one step or ``(T,
    n_bands, m)`` stacked), with the ``DeviceMesh`` and the name of its
    node dim as the pytree context, so ``mix_stacked`` dispatches to
    :func:`mix_stacked_permute` on each rank's row.  Needs the node dim to
    have ``m`` ranks.
    """

    __slots__ = ("offsets", "mesh", "axis", "coeffs")

    def __init__(self, offsets: tuple, mesh, axis: str, coeffs):
        self.offsets = tuple(offsets)
        self.mesh = mesh
        self.axis = axis
        self.coeffs = coeffs

    @classmethod
    def from_dense(cls, phi: np.ndarray, offsets: tuple, mesh,
                   axis: str) -> "PermutePhi":
        """Project a dense phi onto a fixed offset set (raises on leakage)."""
        return cls(offsets, mesh, axis, bands_for_phi(np.asarray(phi),
                                                      offsets))

    def __repr__(self):
        shape = getattr(self.coeffs, "shape", None)
        return (f"PermutePhi(offsets={self.offsets}, axis={self.axis!r}, "
                f"coeffs.shape={shape})")


pytree.register_pytree_node(
    PermutePhi,
    lambda phi: ([phi.coeffs], (phi.offsets, phi.mesh, phi.axis)),
    lambda children, ctx: PermutePhi(ctx[0], ctx[1], ctx[2],
                                     list(children)[0]))


def _permute_axis(phi: PermutePhi) -> spmd.NodeAxis:
    m = phi.coeffs.shape[-1]
    ax = spmd.node_axis(phi.mesh, phi.axis, m)
    if ax.size != m:
        raise ValueError(f"ppermute gossip runs one node a rank: mesh dim "
                         f"{phi.axis!r} has {ax.size} ranks for m={m}")
    return ax


def permute_exchange(phi: PermutePhi, payloads: list) -> list:
    """For every band of ``phi``: each payload tensor of the node
    ``(j + d) % m`` this rank (node ``j``) receives, its own for ``d % m ==
    0``.  One batch of point-to-point exchanges a payload."""
    ax = _permute_axis(phi)
    shifts = [d for d in phi.offsets if d % ax.m]
    out = []
    for x in payloads:
        got = dict(zip(shifts, spmd.shift(x, shifts, ax))) if shifts else {}
        out.append([x if d % ax.m == 0 else got[d] for d in phi.offsets])
    return out


def mix_stacked_permute(phi: PermutePhi, tree):
    """Gossip via one point-to-point exchange a band of each rank's row.

    Numerically identical to :func:`mix_stacked_banded` on the whole stack
    (the same band sum, one term per offset, in the offsets' order); band
    ``d`` becomes one exchange where rank ``j`` sends its row to ``(j - d)
    mod m``: O(degree) point-to-point traffic instead of the dense mix's
    O(m) all-gather."""
    j = _permute_axis(phi).index

    def _mix(leaf):
        (received,) = permute_exchange(phi, [leaf])
        coeffs = as_mix_tensor(phi.coeffs, leaf)
        out = None
        for b, x in enumerate(received):
            term = _coeff(coeffs, b, j, leaf) * x
            out = term if out is None else out + term
        return out

    return pytree.tree_map(_mix, tree)


class GatheredPhi:
    """A dense ``(m, m)`` or :class:`BandedPhi` ``inner`` phi applied to
    node-sharded state (``shard="nodes"``): each rank all-gathers the rows
    over the mesh dim ``axis`` and applies its own rows of the mix.  The
    mesh and axis are the pytree context; ``inner``'s leaves stage and
    slice as usual."""

    __slots__ = ("inner", "mesh", "axis")

    def __init__(self, inner, mesh, axis: str):
        self.inner = inner
        self.mesh = mesh
        self.axis = axis

    @property
    def m(self) -> int:
        inner = self.inner.coeffs if isinstance(self.inner, BandedPhi) \
            else self.inner
        return inner.shape[-1]

    def __repr__(self):
        return f"GatheredPhi(axis={self.axis!r}, inner={self.inner!r})"


pytree.register_pytree_node(
    GatheredPhi,
    lambda phi: ([phi.inner], (phi.mesh, phi.axis)),
    lambda children, ctx: GatheredPhi(list(children)[0], ctx[0], ctx[1]))


def gathered_rows_mix(inner, full: torch.Tensor, rows: slice,
                      like: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of ``inner`` (dense or banded) applied to the whole
    stacked leaf ``full`` (m, ...)."""
    m = full.shape[0]
    if isinstance(inner, BandedPhi):
        coeffs = as_mix_tensor(inner.coeffs, like)
        out = None
        for b, d in enumerate(inner.offsets):
            shifted = torch.roll(full, -d, dims=0) if d else full
            term = _coeff(coeffs, b, rows, like) * shifted[rows]
            out = term if out is None else out + term
        return out
    w = as_mix_tensor(inner, like).to(like.dtype)[rows]
    return (w @ full.reshape(m, -1)).reshape((w.shape[0],) + full.shape[1:])


def mix_stacked_gathered(phi: GatheredPhi, tree):
    """All-gather each leaf's rows, then apply this rank's rows of the
    mix."""
    ax = spmd.node_axis(phi.mesh, phi.axis, phi.m)

    def _mix(leaf):
        full = spmd.all_gather_rows(leaf, ax)
        return gathered_rows_mix(phi.inner, full, ax.rows, leaf)

    return pytree.tree_map(_mix, tree)


def phi_node_axis(phi) -> "spmd.NodeAxis | None":
    """The node axis a sharded phi mixes over (found through wrappers'
    ``inner``), or None for a phi over the whole stack."""
    while phi is not None:
        if isinstance(phi, PermutePhi):
            return _permute_axis(phi)
        if isinstance(phi, GatheredPhi):
            return spmd.node_axis(phi.mesh, phi.axis, phi.m)
        phi = getattr(phi, "inner", None)
    return None


def shard_phi(phi, mesh, axis: str):
    """``phi`` for node-sharded state over ``mesh``'s dim ``axis``: its
    innermost wire format (under the ``inner`` of wrappers such as
    ``CompressedPhi``) becomes a :class:`GatheredPhi`, unless it is a
    :class:`PermutePhi`, which already mixes each rank's row."""
    if isinstance(phi, (GatheredPhi, PermutePhi)):
        return phi
    # a dense tensor's ``inner`` is torch.inner, not a wrapped phi
    inner = None if isinstance(phi, (torch.Tensor, np.ndarray)) \
        else getattr(phi, "inner", None)
    if inner is None:
        return GatheredPhi(phi, mesh, axis)
    out = copy.copy(phi)
    out.inner = shard_phi(inner, mesh, axis)
    return out
