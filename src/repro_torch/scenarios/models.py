"""Seeded network-event models: MixingSchedule-level degradation.  The port
of ``repro.scenarios.models``, numpy only; the port keeps its own copy, so
that nothing of the JAX package is imported.  Its realized matrices equal
the reference's bit for bit (the same event streams, the same Metropolis
reweighting).

The paper's convergence claim is about *time-varying* networks, but the
built-in schedules are benign — periodic, connectivity-preserving, always
on time.  This module injects the adversarial dynamics that make the
time-varying setting hard, as composable wrappers over the existing
contracts (nothing in ``core`` is forked):

* :class:`LinkFailures` / :class:`NodeChurn` degrade the per-step mixing
  matrices (this module): every realized ``W^t`` drops a random subset of
  the base schedule's edges and is Metropolis-reweighted so it STAYS
  doubly stochastic (Assumption 2 survives degradation; Assumption 1's
  b-connectivity is intentionally at risk — that is the experiment).
* :class:`StaleGossip` / :class:`Stragglers` degrade the transport
  (``repro_torch.scenarios.transports``): payloads arrive late or stale,
  as a ``GossipBackend`` wrapper threading a delay buffer through the
  algorithm's mix state.

Event draws come from dedicated counter-based ``np.random`` streams
(``default_rng([seed, salt, t])``): every step's events are a pure
function of ``(seed, t)``, independent of visit order — so the host loop,
the resident path and batched sweeps realize the SAME degraded network,
and scenario seeds never alias schedule-construction seeds (pass the
schedule constructor its own ``np.random.Generator`` to keep even the int
seeds disjoint).

:func:`apply` is the single composition point: it takes a base schedule
plus a list of models and returns the ``(schedule, gossip)`` pair to hand
to ``runner.run`` / ``run_sweep``.  Zero-intensity models (p=0, delay=0,
slowdown=1) short-circuit to the UNWRAPPED inputs, so the zero scenario is
bit-for-bit the baseline run by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from ..core import graphs

__all__ = [
    "LinkFailures",
    "NodeChurn",
    "StaleGossip",
    "Stragglers",
    "ScenarioSchedule",
    "wrap_schedule",
    "transport_spec",
    "apply",
]

_TOL = 1e-12

# Stream salts: each event process draws from its own counter-based stream,
# so composing models never makes one model's draws shift another's.
_LINK_SALT = 0x11
_CHURN_SALT = 0x22


# ---------------------------------------------------------------------------
# Model declarations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkFailures:
    """Each base-schedule edge drops independently with probability ``p``
    per slot (symmetric: a link is down in both directions or neither)."""
    p: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"LinkFailures.p must be in [0, 1], got {self.p}")


@dataclasses.dataclass(frozen=True)
class NodeChurn:
    """Nodes leave and rejoin: each node is DOWN with probability ``p`` per
    dwell window of ``dwell`` slots (re-drawn every window, so outages last
    ``dwell`` steps).  A down node is isolated — all its links drop and its
    realized self-weight is 1 (it keeps computing locally on its own
    iterate, rejoining with whatever it drifted to)."""
    p: float = 0.0
    dwell: int = 10

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"NodeChurn.p must be in [0, 1], got {self.p}")
        if self.dwell < 1:
            raise ValueError(f"NodeChurn.dwell must be >= 1, got {self.dwell}")


@dataclasses.dataclass(frozen=True)
class StaleGossip:
    """Bounded-delay asynchronous gossip: every transmitted payload arrives
    ``delay`` slots late (neighbors mix iterates from ``delay`` steps ago;
    each node's own contribution stays current).  Transport-level — see
    ``repro_torch.scenarios.transports.ScenarioBackend``."""
    delay: int = 0

    def __post_init__(self):
        if self.delay < 0:
            raise ValueError(f"StaleGossip.delay must be >= 0, "
                             f"got {self.delay}")


@dataclasses.dataclass(frozen=True)
class Stragglers:
    """Heterogeneous compute: a node slowed by ``slowdown`` (>= 1) has a
    fresh iterate ready for a gossip slot only with probability
    ``1/slowdown``; otherwise its neighbors receive its last transmitted
    iterate again.  ``slowdown=1`` is exactly no-op.  Transport-level."""
    slowdown: float = 1.0

    def __post_init__(self):
        if self.slowdown < 1.0:
            raise ValueError(f"Stragglers.slowdown must be >= 1, "
                             f"got {self.slowdown}")

    @property
    def p(self) -> float:
        """Per-slot probability of missing the gossip deadline."""
        return 1.0 - 1.0 / self.slowdown


# ---------------------------------------------------------------------------
# Schedule wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSchedule(graphs.MixingSchedule):
    """A base schedule seen through link-failure / node-churn events.

    ``matrix(t)`` realizes the degraded ``W^t``: the base matrix's edge set
    minus this slot's dropped links and down nodes, Metropolis-reweighted
    (:func:`graphs.metropolis_weights`) so every realized matrix is doubly
    stochastic with symmetric weights.  Slots where nothing drops return
    the base matrix OBJECT unchanged — the zero-event path is bit-for-bit
    the base schedule.

    ``aperiodic`` is True: products are a function of the absolute slot,
    so transport caches key on it (``transport._phi_key``); band/offset
    unions are computed on ``structure_schedule`` (the base), a valid
    superset because degradation only removes edges.  ``eta``/``b`` are
    inherited from the base as the UNDEGRADED reference constants —
    degraded realizations can violate b-connectivity (that is the point
    of the experiment), so Lemma-1 constants computed from them describe
    the best case, not the realized sequence.
    """

    base: Any = None
    link_p: float = 0.0
    churn_p: float = 0.0
    churn_dwell: int = 10
    seed: int = 0
    realized: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def aperiodic(self) -> bool:
        return True

    @property
    def structure_schedule(self) -> graphs.MixingSchedule:
        return self.base.structure_schedule

    def matrix(self, t: int) -> np.ndarray:
        w = self.realized.get(t)
        if w is None:
            w = self.realized[t] = self._realize(t)
        return w

    def _realize(self, t: int) -> np.ndarray:
        base_w = self.base.matrix(t)
        m = base_w.shape[0]
        adj = (np.abs(base_w) > _TOL) & ~np.eye(m, dtype=bool)
        dropped = False
        if self.link_p > 0.0:
            iu, ju = np.nonzero(np.triu(adj, 1))
            if len(iu):
                rng = np.random.default_rng([self.seed, _LINK_SALT, t])
                drop = rng.random(len(iu)) < self.link_p
                if drop.any():
                    adj[iu[drop], ju[drop]] = False
                    adj[ju[drop], iu[drop]] = False
                    dropped = True
        if self.churn_p > 0.0:
            window = t // self.churn_dwell
            rng = np.random.default_rng([self.seed, _CHURN_SALT, window])
            down = rng.random(m) < self.churn_p
            if down.any() and (adj[down, :].any() or adj[:, down].any()):
                adj[down, :] = False
                adj[:, down] = False
                dropped = True
        if not dropped:
            return base_w
        return graphs.metropolis_weights(adj)


def wrap_schedule(schedule: graphs.MixingSchedule,
                  models: Iterable, seed: int = 0) -> graphs.MixingSchedule:
    """Wrap ``schedule`` in the schedule-level models of ``models``
    (transport-level models are ignored here — see :func:`transport_spec`).
    Returns the schedule UNWRAPPED when every schedule-level model is
    zero-intensity."""
    link_p = 0.0
    churn_p = 0.0
    churn_dwell = 10
    for mdl in models:
        if isinstance(mdl, LinkFailures):
            if link_p:
                raise ValueError("compose at most one LinkFailures model")
            link_p = mdl.p
        elif isinstance(mdl, NodeChurn):
            if churn_p:
                raise ValueError("compose at most one NodeChurn model")
            churn_p, churn_dwell = mdl.p, mdl.dwell
    if link_p == 0.0 and churn_p == 0.0:
        return schedule
    if isinstance(schedule, ScenarioSchedule):
        raise ValueError("schedule is already scenario-wrapped; compose all "
                         "models in ONE apply()/wrap_schedule() call")
    tags = []
    if link_p:
        tags.append(f"links{link_p:g}")
    if churn_p:
        tags.append(f"churn{churn_p:g}x{churn_dwell}")
    return ScenarioSchedule(
        matrices=schedule.matrices, b=schedule.b, eta=schedule.eta,
        name=f"{schedule.name}+{'+'.join(tags)}@{seed}",
        base=schedule, link_p=link_p, churn_p=churn_p,
        churn_dwell=churn_dwell, seed=seed)


def transport_spec(models: Iterable) -> tuple[int, float]:
    """The transport-level slice of ``models``: ``(delay, straggler_p)``."""
    delay = 0
    straggler_p = 0.0
    for mdl in models:
        if isinstance(mdl, StaleGossip):
            if delay:
                raise ValueError("compose at most one StaleGossip model")
            delay = mdl.delay
        elif isinstance(mdl, Stragglers):
            if straggler_p:
                raise ValueError("compose at most one Stragglers model")
            straggler_p = mdl.p
    return delay, straggler_p


def _check_models(models: Iterable) -> list:
    models = list(models)
    known = (LinkFailures, NodeChurn, StaleGossip, Stragglers)
    for mdl in models:
        if not isinstance(mdl, known):
            raise TypeError(f"unknown scenario model {mdl!r}: expected one "
                            f"of {[c.__name__ for c in known]}")
    return models


def apply(schedule: graphs.MixingSchedule, models: Iterable = (), *,
          gossip="dense", compress_bits: int | None = None, seed: int = 0):
    """Compose ``models`` over ``(schedule, gossip)``.

    Returns the ``(schedule, gossip)`` pair to pass to ``runner.run`` /
    ``run_sweep``.  Composition order is fixed (models are declarative, the
    order of the list does not matter): link/churn events degrade the
    schedule; straggler staleness, then bounded delay, then quantization
    (``compress_bits``) stack on the transport, innermost-compression last
    — see ``repro_torch.scenarios.transports``.

    Zero-intensity inputs (all models at p=0 / delay=0 / slowdown=1 and no
    ``compress_bits``) return the arguments UNCHANGED, so the zero scenario
    is bit-for-bit the unwrapped baseline — including its wire accounting.
    Non-zero scenarios route the transport through ``ScenarioBackend``,
    whose accounting charges only links that actually carried mass (dropped
    links are free), using a point-to-point model on the realized support.
    """
    from . import transports  # local import: transports imports models

    models = _check_models(models)
    sched = wrap_schedule(schedule, models, seed=seed)
    delay, straggler_p = transport_spec(models)
    degraded = sched is not schedule
    if not degraded and delay == 0 and straggler_p == 0.0 \
            and compress_bits is None:
        return schedule, gossip
    backend = transports.ScenarioBackend(
        inner=gossip, delay=delay, straggler_p=straggler_p, seed=seed,
        compress_bits=compress_bits)
    return sched, backend
