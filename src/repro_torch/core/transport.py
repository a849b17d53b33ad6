"""Gossip transports: HOW the doubly-stochastic mixing moves parameters
between nodes.  The dense subset of ``repro.core.transport``.

A :class:`GossipBackend` owns

* ``prepare(schedule, meta) -> aux`` — static precompute, once per run,
* ``phi_for(aux, slot, rounds) -> phi`` — the host-side per-step wire
  representation, memoized in ``aux`` on ``(slot % period, rounds)``,
* ``bytes_per_step`` / ``bytes_per_link`` — wire-cost accounting.

Only ``dense`` is ported: one pre-multiplied ``(m, m)`` product per step.
The ``"auto"`` rule is the reference's, so it may name a transport the
port does not have yet (``banded`` for a ring with single-round gossip,
``ppermute`` on a mesh, ``compressed``); resolving such a name raises
``NotImplementedError``.  Runs of the port pin ``gossip="dense"``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
from torch.utils import _pytree as pytree

from . import gossip, graphs

__all__ = [
    "band_offset_union",
    "GossipBackend",
    "DenseBackend",
    "GOSSIP_BACKENDS",
    "UNPORTED_BACKENDS",
    "select_backend_name",
    "resolve_backend",
    "node_param_count",
    "mix_matrix",
]

F32_BYTES = 4

# transports of the reference that the port has not built yet
UNPORTED_BACKENDS = ("banded", "ppermute", "compressed")


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
    dense lowering (the caller then keeps the unfused step)."""
    return phi if getattr(phi, "ndim", None) == 2 else None


class GossipBackend:
    """Protocol base.  Instances are stateless; per-run state lives in the
    ``aux`` returned by :meth:`prepare`.  ``meta`` is the driven
    algorithm's ``AlgoMeta``."""

    name: str = "?"

    def prepare(self, schedule: graphs.MixingSchedule, meta) -> Any:
        raise NotImplementedError

    def phi_for(self, aux, slot: int, rounds: int):
        raise NotImplementedError

    def bytes_per_step(self, aux, phi, param_count: int) -> int:
        raise NotImplementedError

    def bytes_per_link(self, aux, phi, param_count: int) -> dict:
        raise NotImplementedError


class _DenseAux(NamedTuple):
    schedule: graphs.MixingSchedule
    m: int
    cache: dict


class DenseBackend(GossipBackend):
    """One pre-multiplied ``(m, m)`` product per step."""

    name = "dense"

    def prepare(self, schedule, meta):
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


GOSSIP_BACKENDS: dict[str, GossipBackend] = {
    "dense": DenseBackend(),
}


def select_backend_name(schedule: graphs.MixingSchedule, meta,
                        mesh=None) -> str:
    """The reference's ``"auto"`` rule: a mesh -> ``"ppermute"``; else a
    band union strictly smaller than m -> ``"banded"``; else ``"dense"``."""
    if mesh is not None:
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
    if name in UNPORTED_BACKENDS:
        how = (f"gossip='auto' picked {name!r} for this schedule"
               if gossip == "auto" else f"gossip={name!r}")
        raise NotImplementedError(
            f"{how}, but the {name} transport is not ported to PyTorch yet "
            f"(ROADMAP Queue 1 item 7); pass gossip='dense'")
    try:
        return GOSSIP_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown gossip backend {gossip!r}: expected 'auto', one of "
            f"{sorted(GOSSIP_BACKENDS)}, or a GossipBackend instance"
        ) from None
