"""Gossip transports: HOW the doubly-stochastic mixing moves parameters
between nodes.  The port of ``repro.core.transport``.

A :class:`GossipBackend` owns

* ``prepare(schedule, meta, *, mesh=None) -> aux`` — static precompute,
  once per run,
* ``phi_for(aux, slot, rounds) -> phi`` — the host-side per-step wire
  representation, memoized in ``aux`` on ``(slot % period, rounds)``,
* ``bytes_per_step`` / ``bytes_per_link`` — wire-cost accounting.

Registered backends (:data:`GOSSIP_BACKENDS`):

``dense``
    One pre-multiplied ``(m, m)`` product per step, charged as an
    all-gather of the stacked buffer.
``banded``
    Cyclic-band decomposition (``gossip.BandedPhi``) on the schedule's
    static offset union: each band is one ``torch.roll``, and each nonzero
    off-diagonal coefficient is charged as one parameter vector over one
    link.
``ppermute``
    The banded decomposition over a node axis of ranks, one node a rank
    (``gossip.PermutePhi``): each band is one point-to-point exchange of
    the rank's row (``core.spmd``); charged as ``banded``.
``compressed``
    Wraps any of them: payloads ride the inner wire format int-quantized
    with an error-feedback residual (``core.compression``), cutting bytes
    by ``32 / bits``.  Stateful: the driven algorithm threads a mix state
    (``Algorithm.init_mix_state``).

``"auto"`` is the reference's rule: a mesh with a node axis of size m ->
``ppermute``; else a band union strictly smaller than m -> ``banded``,
else ``dense``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
from torch.utils import _pytree as pytree

from . import compression, gossip, graphs, spmd

__all__ = [
    "TransportMeta",
    "band_offset_union",
    "GossipBackend",
    "DenseBackend",
    "BandedBackend",
    "PPermuteBackend",
    "CompressedBackend",
    "GOSSIP_BACKENDS",
    "select_backend_name",
    "resolve_backend",
    "node_param_count",
    "mix_matrix",
    "batch_phis",
]

F32_BYTES = 4


class TransportMeta(NamedTuple):
    """What ``prepare`` needs to know about the driven loop: which
    ``rounds`` values the gossip policy will request.  ``AlgoMeta`` is
    duck-compatible (the runner passes it directly); loops without an
    AlgoMeta (the LM trainer) build one via :meth:`constant`."""
    outer_lengths: tuple | None
    num_steps: int | None
    gossip_rounds: Callable[[int], int]

    @classmethod
    def constant(cls, rounds: int) -> "TransportMeta":
        """A fixed-rounds gossip policy (the LM trainer's): the rounds-value
        set is the singleton {rounds}, so one probe step suffices."""
        return cls(None, 1, lambda k: rounds)


def _rounds_values(meta) -> list[int]:
    if meta.outer_lengths is not None:
        ks = range(1, max(meta.outer_lengths) + 1)
    else:
        ks = range(1, (meta.num_steps or 1) + 1)
    return sorted({meta.gossip_rounds(k) for k in ks})


def band_offset_union(schedule: graphs.MixingSchedule, meta) -> tuple:
    """Offsets of every `rounds`-product the schedule can produce, for every
    rounds value the gossip policy will request; stops once it saturates
    at m offsets."""
    schedule = schedule.structure_schedule
    m = schedule.m
    offs: set = set()
    for rounds in _rounds_values(meta):
        offs.update(gossip.schedule_band_offsets(schedule, rounds))
        if len(offs) >= m:
            break
    return tuple(sorted(offs))


def _phi_key(schedule: graphs.MixingSchedule, slot: int, rounds: int):
    if schedule.aperiodic:
        return (slot, rounds)
    return (slot % schedule.period, rounds)


def node_param_count(tree) -> int:
    """Per-node parameter count of a stacked tree (leaves (m, ...))."""
    return sum(int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64))
               for leaf in pytree.tree_leaves(tree))


def mix_matrix(phi):
    """The dense (m, m) mixing matrix (numpy or tensor) the fused
    resident-step kernel consumes, or ``None`` when the wire format has no
    dense lowering (the caller then keeps the unfused step).  A
    ``BandedPhi`` lowers through ``gossip.banded_to_dense`` on its
    coefficients' device; a stateful-only phi (``gossip.mark_stateful``:
    ``CompressedPhi``, the scenario pipeline) threads mix state and has
    none."""
    if isinstance(phi, gossip.BandedPhi):
        return gossip.banded_to_dense(phi.offsets, phi.coeffs)
    if isinstance(phi, (gossip.PermutePhi, gossip.GatheredPhi)):
        return None             # a rank holds its rows, not the stack
    if gossip._STATEFUL_ONLY and isinstance(phi, gossip._STATEFUL_ONLY):
        return None
    return phi if getattr(phi, "ndim", None) == 2 else None


def batch_phis(phis: list) -> Any:
    """Stack the cells' wire representations of one step along a new
    leading cell axis (a batched sweep whose cells gossip over different
    schedules).  Every phi must share its pytree structure, static parts
    included (one ``BandedPhi`` offset union): cells whose schedules
    decompose differently cannot share one batched program, and
    ``gossip="dense"``, whose (m, m) wire format has no static part, batches
    any topologies.  A leaf that is None (a scenario phi's absent straggler
    mask) must be None in every cell, and stays None.  Leaf dtypes are
    kept."""
    def spec(phi):
        leaves, tree_spec = pytree.tree_flatten(phi)
        return f"{tree_spec} absent={[a is None for a in leaves]}"

    specs = {spec(p) for p in phis}
    if len(specs) > 1:
        raise ValueError(
            f"cannot batch gossip wire representations with different "
            f"static structure across sweep cells: {sorted(specs)}; cells "
            f"whose schedules decompose into different band structures "
            f"need gossip='dense' to share one batched program")
    return pytree.tree_map(
        lambda *leaves: None if leaves[0] is None
        else np.stack([np.asarray(a) for a in leaves]), *phis)


def _active_entries(offsets: tuple, coeffs, m: int) -> Iterator:
    """(band offset d, node i) pairs whose coefficient carries mass this
    step: node i receives ``x_{(i+d) mod m}`` with weight coeffs[b][i]."""
    c = np.asarray(coeffs)
    for b, d in enumerate(offsets):
        if d % m == 0:
            continue
        for i in np.flatnonzero(np.abs(c[b]) > 1e-12):
            yield d, int(i)


def _banded_wire_bytes(offsets: tuple, coeffs, m: int,
                       param_count: int) -> int:
    """Point-to-point accounting for band-structured gossip: each nonzero
    off-diagonal coefficient moves one param vector over one link."""
    n = sum(1 for _ in _active_entries(offsets, coeffs, m))
    return n * param_count * F32_BYTES


def _banded_link_bytes(offsets: tuple, coeffs, m: int,
                       param_count: int) -> dict:
    """Per-directed-link refinement of :func:`_banded_wire_bytes`: band
    ``d`` at node ``i`` moves one param vector over ``(i+d) mod m -> i``."""
    links: dict = {}
    for d, i in _active_entries(offsets, coeffs, m):
        key = ((i + d) % m, i)
        links[key] = links.get(key, 0) + param_count * F32_BYTES
    return links


class GossipBackend:
    """Protocol base.  Instances are stateless; per-run state lives in the
    ``aux`` returned by :meth:`prepare`.  ``meta`` is the driven
    algorithm's ``AlgoMeta``.  ``needs_mix_state`` marks stateful
    transports: the runner asks the driven algorithm to thread the state
    (``Algorithm.init_mix_state``)."""

    name: str = "?"
    needs_mix_state: bool = False

    def prepare(self, schedule: graphs.MixingSchedule, meta, *,
                mesh=None) -> Any:
        raise NotImplementedError

    def phi_for(self, aux, slot: int, rounds: int):
        raise NotImplementedError

    def bytes_per_step(self, aux, phi, param_count: int) -> int:
        raise NotImplementedError

    def bytes_per_link(self, aux, phi, param_count: int) -> dict:
        raise NotImplementedError

    def init_mix_state(self, aux, x0):
        """Per-run transport state threaded through the algorithm state
        (``needs_mix_state`` backends only)."""
        raise NotImplementedError(
            f"gossip backend {self.name!r} is stateless")


class _DenseAux(NamedTuple):
    schedule: graphs.MixingSchedule
    m: int
    cache: dict


class DenseBackend(GossipBackend):
    """One pre-multiplied ``(m, m)`` product per step."""

    name = "dense"

    def prepare(self, schedule, meta, *, mesh=None):
        return _DenseAux(schedule, schedule.m, {})

    def phi_for(self, aux, slot, rounds):
        key = _phi_key(aux.schedule, slot, rounds)
        phi = aux.cache.get(key)
        if phi is None:
            phi = aux.cache[key] = aux.schedule.consensus_rounds(slot, rounds)
        return phi

    def bytes_per_step(self, aux, phi, param_count):
        # a dense mix is charged as an all-gather of the stacked buffer:
        # every node receives the other m - 1 copies
        return aux.m * (aux.m - 1) * param_count * F32_BYTES

    def bytes_per_link(self, aux, phi, param_count):
        return {(j, i): param_count * F32_BYTES
                for i in range(aux.m) for j in range(aux.m) if i != j}


class _BandedAux(NamedTuple):
    schedule: graphs.MixingSchedule
    m: int
    offsets: tuple
    cache: dict


class BandedBackend(GossipBackend):
    """Cyclic-band decomposition on the schedule's static offset union."""

    name = "banded"

    def prepare(self, schedule, meta, *, mesh=None):
        offsets = band_offset_union(schedule, meta)
        if len(offsets) >= schedule.m:
            # only reachable when banded is requested by name ("auto" picks
            # dense on a saturated union): still correct, but m shifted
            # passes per step are slower than one (m, m) product
            warnings.warn(
                f"{schedule.name}: banded gossip needs all {len(offsets)} "
                f"of {schedule.m} band offsets, no O(degree) structure to "
                f"exploit; gossip='auto' or 'dense' will be faster (cap "
                f"multi-consensus rounds, e.g. k_max, to keep products "
                f"banded)", RuntimeWarning, stacklevel=3)
        return _BandedAux(schedule, schedule.m, offsets, {})

    def phi_for(self, aux, slot, rounds):
        key = _phi_key(aux.schedule, slot, rounds)
        phi = aux.cache.get(key)
        if phi is None:
            phi = aux.cache[key] = gossip.BandedPhi.from_dense(
                aux.schedule.consensus_rounds(slot, rounds), aux.offsets)
        return phi

    def bytes_per_step(self, aux, phi, param_count):
        return _banded_wire_bytes(phi.offsets, phi.coeffs, aux.m, param_count)

    def bytes_per_link(self, aux, phi, param_count):
        return _banded_link_bytes(phi.offsets, phi.coeffs, aux.m, param_count)


class _PermuteAux(NamedTuple):
    schedule: graphs.MixingSchedule
    m: int
    offsets: tuple
    mesh: Any
    axis: str
    cache: dict


def _node_axis(mesh, m: int) -> str | None:
    """The mesh dim carrying one node a rank, if any."""
    for axis, size in spmd.mesh_shape(mesh).items():
        if size == m:
            return axis
    return None


class PPermuteBackend(GossipBackend):
    """Banded gossip lowered to one point-to-point exchange a band over a
    node axis of ranks (``gossip.PermutePhi``).

    Needs a mesh with a dim of size m (one node a rank).  When ``mesh`` is
    None it builds a 1-D ``("nodes",)`` mesh over the default group, which
    must have m ranks; without an initialized group it raises, naming
    ``spmd.spawn``.
    """

    name = "ppermute"

    def prepare(self, schedule, meta, *, mesh=None):
        m = schedule.m
        if mesh is None:
            spmd.require_group(f"ppermute gossip over m={m} nodes (one node "
                               f"a rank, {m} ranks)")
            if spmd.dist.get_world_size() != m:
                raise ValueError(
                    f"ppermute gossip needs a node axis of m={m} ranks, but "
                    f"the default group has {spmd.dist.get_world_size()}; "
                    f"spawn {m} ranks or pass mesh=")
            mesh, axis = spmd.world_mesh("nodes"), "nodes"
        else:
            axis = _node_axis(mesh, m)
            if axis is None:
                raise ValueError(
                    f"mesh {spmd.mesh_shape(mesh)} has no dim of size m={m} "
                    f"to carry the node axis")
        return _PermuteAux(schedule, m, band_offset_union(schedule, meta),
                           mesh, axis, {})

    def phi_for(self, aux, slot, rounds):
        key = _phi_key(aux.schedule, slot, rounds)
        phi = aux.cache.get(key)
        if phi is None:
            phi = aux.cache[key] = gossip.PermutePhi.from_dense(
                aux.schedule.consensus_rounds(slot, rounds), aux.offsets,
                aux.mesh, aux.axis)
        return phi

    def bytes_per_step(self, aux, phi, param_count):
        return _banded_wire_bytes(phi.offsets, phi.coeffs, aux.m, param_count)

    def bytes_per_link(self, aux, phi, param_count):
        return _banded_link_bytes(phi.offsets, phi.coeffs, aux.m, param_count)


class _CompressedAux(NamedTuple):
    inner_backend: GossipBackend
    inner_aux: Any
    bits: int


@dataclasses.dataclass(frozen=True)
class CompressedBackend(GossipBackend):
    """Error-feedback quantized gossip over either inner wire format.

    ``inner`` names (or is) the transport the quantized payload rides on;
    ``bits`` the integer width.  Stateful: the residual accumulator threads
    through the algorithm state (``Algorithm.init_mix_state``), so only
    algorithms that thread a mix state can be driven compressed.
    """

    inner: Any = "dense"   # str name or GossipBackend instance
    bits: int = 8

    name = "compressed"
    needs_mix_state = True

    def _inner_backend(self) -> GossipBackend:
        if isinstance(self.inner, str):
            if self.inner == "compressed":
                raise ValueError("compressed cannot wrap itself")
            return resolve_backend(self.inner, None, None)
        return self.inner

    def prepare(self, schedule, meta, *, mesh=None):
        ib = self._inner_backend()
        return _CompressedAux(ib, ib.prepare(schedule, meta, mesh=mesh),
                              self.bits)

    def phi_for(self, aux, slot, rounds):
        return compression.CompressedPhi(
            aux.inner_backend.phi_for(aux.inner_aux, slot, rounds), aux.bits)

    def init_mix_state(self, aux, x0) -> compression.CompressionState:
        return compression.init_state(x0)

    def bytes_per_step(self, aux, phi, param_count):
        inner = aux.inner_backend.bytes_per_step(aux.inner_aux, phi.inner,
                                                 param_count)
        return inner * aux.bits // 32

    def bytes_per_link(self, aux, phi, param_count):
        # per-link floors can undershoot the single-floor total when bits
        # does not divide 32; the remainder goes to the links in order, so
        # the map sums exactly to bytes_per_step
        inner = aux.inner_backend.bytes_per_link(aux.inner_aux, phi.inner,
                                                 param_count)
        links = {link: b * aux.bits // 32 for link, b in inner.items()}
        remainder = (self.bytes_per_step(aux, phi, param_count)
                     - sum(links.values()))
        for link in sorted(links):
            if remainder <= 0:
                break
            links[link] += 1
            remainder -= 1
        return links


GOSSIP_BACKENDS: dict[str, GossipBackend] = {
    "dense": DenseBackend(),
    "banded": BandedBackend(),
    "ppermute": PPermuteBackend(),
    "compressed": CompressedBackend(),
}


def mesh_aux(aux) -> "_PermuteAux | None":
    """The ppermute transport's aux within ``aux`` (through the ``inner_aux``
    of wrapping transports), or None: a run whose transport exchanges over
    a node axis of ranks holds node-sharded state."""
    while aux is not None:
        if isinstance(aux, _PermuteAux):
            return aux
        aux = getattr(aux, "inner_aux", None)
    return None


def select_backend_name(schedule: graphs.MixingSchedule, meta,
                        mesh=None) -> str:
    """The reference's ``"auto"`` rule: a mesh with a dim of size m ->
    ``"ppermute"``; else a band union strictly smaller than m ->
    ``"banded"``; else ``"dense"``."""
    if mesh is not None and _node_axis(mesh, schedule.m) is not None:
        return "ppermute"
    if len(band_offset_union(schedule, meta)) >= schedule.m:
        return "dense"
    return "banded"


def resolve_backend(gossip, schedule: graphs.MixingSchedule, meta,
                    mesh=None) -> GossipBackend:
    """``gossip`` is a registry name, ``"auto"``, or a backend instance."""
    if not isinstance(gossip, str):
        return gossip
    name = (select_backend_name(schedule, meta, mesh)
            if gossip == "auto" else gossip)
    try:
        return GOSSIP_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown gossip backend {gossip!r}: expected 'auto', one of "
            f"{sorted(GOSSIP_BACKENDS)}, or a GossipBackend instance"
        ) from None
