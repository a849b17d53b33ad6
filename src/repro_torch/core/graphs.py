"""Time-varying communication graphs and doubly-stochastic mixing matrices.

Implements the paper's network model (Section II-A):

* b-connected time-varying graph sequences (Assumption 1): the union of any
  ``b`` consecutive edge sets is connected.
* Doubly-stochastic mixing matrices ``W^t`` (Assumption 2) with a uniform
  positive lower bound ``eta`` on nonzero entries.
* The aggregated communication matrix ``Phi(l, g) = W^g ... W^l`` and the
  Lemma-1 geometric-contraction constants ``Gamma = 2(1 + eta^{-b0})``,
  ``gamma = 1 - eta^{b0}`` with ``b0 = (m - 1) b``.

All matrices are plain ``numpy`` float64 on host: mixing schedules are
precomputed outside the device step (they are tiny, m <= a few dozen) and fed
to the device as a single multi-consensus product.

This module is a copy of ``repro.core.graphs``: the PyTorch port keeps its
own, because importing the reference's would import JAX.  The parity tests
hold the two bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence

import numpy as np

__all__ = [
    "MixingSchedule",
    "metropolis_weights",
    "ring_matrix",
    "fully_connected_matrix",
    "exponential_graph_matrices",
    "edge_matching_matrices",
    "b_connected_ring_schedule",
    "random_b_connected_schedule",
    "static_schedule",
    "is_doubly_stochastic",
    "spectral_gap",
    "second_largest_singular_value",
    "lemma1_constants",
    "phi_product",
    "consensus_distance",
]


# ---------------------------------------------------------------------------
# Matrix constructors
# ---------------------------------------------------------------------------

def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings doubly-stochastic weights for an undirected graph.

    ``w_ij = 1 / (1 + max(deg_i, deg_j))`` for edges, self-weight takes the
    remainder.  Always symmetric and doubly stochastic; nonzero entries are
    bounded below by ``1 / (1 + max_deg)`` (Assumption 2's ``eta``).
    """
    adj = np.asarray(adj, dtype=bool)
    m = adj.shape[0]
    adj = adj & ~np.eye(m, dtype=bool)  # no self loops in adjacency
    deg = adj.sum(axis=1)
    w = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        for j in range(i + 1, m):
            if adj[i, j]:
                w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    w[np.arange(m), np.arange(m)] = 1.0 - w.sum(axis=1)
    return w


def ring_matrix(m: int, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    """Symmetric ring gossip matrix: each node averages with both neighbors."""
    if m == 1:
        return np.ones((1, 1))
    if m == 2:
        return np.full((2, 2), 0.5)
    w = np.eye(m) * self_weight
    side = (1.0 - self_weight) / 2.0
    for i in range(m):
        w[i, (i + 1) % m] = side
        w[i, (i - 1) % m] = side
    return w


def fully_connected_matrix(m: int) -> np.ndarray:
    return np.full((m, m), 1.0 / m)


def exponential_graph_matrices(m: int) -> list[np.ndarray]:
    """One-peer exponential graph family: at slot t each node talks to the
    peer ``2^t`` hops away.  Each matrix is a disjoint pairwise averaging
    (doubly stochastic); the family over ``ceil(log2 m)`` slots is connected,
    so the sequence is b-connected with ``b = ceil(log2 m)``.
    """
    mats = []
    hops = 1
    while hops < m:
        w = np.zeros((m, m))
        paired = np.zeros(m, dtype=bool)
        for i in range(m):
            j = (i + hops) % m
            if not paired[i] and not paired[j] and i != j:
                w[i, j] = w[j, i] = 0.5
                w[i, i] = w[j, j] = 0.5
                paired[i] = paired[j] = True
        for i in range(m):
            if not paired[i]:
                w[i, i] = 1.0
        mats.append(w)
        hops *= 2
    return mats or [np.ones((1, 1))]


def edge_matching_matrices(m: int) -> list[np.ndarray]:
    """Edge matchings of a ring: disjoint-pair matrices whose union is the
    full ring.

    Models TDMA-style link activation (only non-interfering links are active
    simultaneously) — the paper's motivating time-varying scenario.  For even
    m the even/odd matchings cover all m ring edges, so the sequence is
    b-connected with b = 2.  For odd m the closing edge (m-1, 0) conflicts
    with BOTH matchings (node 0 is matched in the even one, node m-1 in the
    odd one), so a third matching carries it and b = 3.  (Before this fix
    the closing edge was silently dropped for odd m: the union degenerated
    from the advertised ring to a path, whose far-end nodes only exchange
    information through every intermediate hop — a strictly weaker topology
    than claimed, with a correspondingly worse Lemma-1 contraction.)  Use
    ``b = len(result)``.
    """
    even = np.eye(m)
    odd = np.eye(m)
    for i in range(0, m - 1, 2):
        even[i, i] = even[i + 1, i + 1] = 0.5
        even[i, i + 1] = even[i + 1, i] = 0.5
    for i in range(1, m - 1, 2):
        odd[i, i] = odd[i + 1, i + 1] = 0.5
        odd[i, i + 1] = odd[i + 1, i] = 0.5
    mats = [even, odd]
    if m > 2:
        if m % 2 == 0:
            # close the ring in the odd matching (0 and m-1 are both free)
            odd[0, 0] = odd[m - 1, m - 1] = 0.5
            odd[0, m - 1] = odd[m - 1, 0] = 0.5
        else:
            closing = np.eye(m)
            closing[0, 0] = closing[m - 1, m - 1] = 0.5
            closing[0, m - 1] = closing[m - 1, 0] = 0.5
            mats.append(closing)
    return mats


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MixingSchedule:
    """A periodic sequence of doubly-stochastic mixing matrices.

    ``matrix(t)`` returns ``W^t``; ``phi(l, g)`` returns the aggregated
    product ``W^g @ ... @ W^l`` used by multi-consensus (host-side, so a
    k-round consensus costs a single device collective).
    """

    matrices: tuple  # tuple[np.ndarray, ...]
    b: int           # connectivity window (Assumption 1)
    eta: float       # entry lower bound (Assumption 2)
    name: str = "schedule"

    @property
    def m(self) -> int:
        return self.matrices[0].shape[0]

    @property
    def period(self) -> int:
        return len(self.matrices)

    @property
    def aperiodic(self) -> bool:
        """True when ``matrix(t)`` is NOT a pure function of ``t % period``.

        Transport caches key their per-slot phi products on
        ``slot % period`` only when this is False; scenario wrappers that
        degrade matrices per absolute step override this.
        """
        return False

    @property
    def structure_schedule(self) -> "MixingSchedule":
        """Schedule whose sparsity pattern bounds this one's (self here).

        Scenario wrappers return their base schedule: a degraded matrix only
        ever REMOVES edges, and supports of products of nonnegative matrices
        are monotone in the factor supports, so band/offset unions computed
        on the base schedule are valid (superset) for the wrapper.
        """
        return self

    def matrix(self, t: int) -> np.ndarray:
        return self.matrices[t % self.period]

    def phi(self, l: int, g: int) -> np.ndarray:
        """Phi(l, g) = W^g W^{g-1} ... W^l (inclusive), Eq. before Lemma 1."""
        out = np.eye(self.m)
        for t in range(l, g + 1):
            out = self.matrix(t) @ out
        return out

    def consensus_rounds(self, t0: int, rounds: int) -> np.ndarray:
        """Product of ``rounds`` consecutive matrices starting at slot t0."""
        if rounds <= 0:
            return np.eye(self.m)
        return self.phi(t0, t0 + rounds - 1)

    def iter_matrices(self, start: int = 0) -> Iterator[np.ndarray]:
        t = start
        while True:
            yield self.matrix(t)
            t += 1


def _as_rng(seed) -> np.random.Generator:
    """Accept either an int seed or an already-constructed Generator.

    Passing a Generator lets callers keep schedule randomness on a stream
    that cannot alias a scenario/failure stream built from the same int.
    """
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def static_schedule(w: np.ndarray, name: str = "static") -> MixingSchedule:
    eta = float(w[w > 1e-12].min()) if (w > 1e-12).any() else 0.0
    return MixingSchedule(matrices=(w,), b=1, eta=eta, name=name)


def b_connected_ring_schedule(m: int, b: int,
                              seed: "int | np.random.Generator" = 0,
                              ) -> MixingSchedule:
    """Paper Section V-D: a set of ``b`` doubly-stochastic matrices such that
    only the union of all ``b`` of them is connected; matrices are cycled
    periodically, so the sequence is b-connected.

    Construction: partition the ring's m edges into ``b`` groups; slot t
    activates group ``t mod b`` as a disjoint-pair averaging (plus self
    loops).  With b = 1 this degenerates to the full ring matrix.
    """
    if b <= 1:
        return static_schedule(ring_matrix(m), name=f"ring{m}")
    rng = _as_rng(seed)
    edges = [(i, (i + 1) % m) for i in range(m)]
    order = list(rng.permutation(m))
    # Greedy matching partition: place every ring edge into one of the b
    # slots such that each slot stays a disjoint matching.  A cycle has max
    # degree 2, so b >= 2 slots always suffice (add extra slots never hurts:
    # all m edges MUST be placed or the union is not connected).
    groups: list[list[tuple[int, int]]] = [[] for _ in range(b)]
    used = [set() for _ in range(b)]
    for idx in order:
        i, j = edges[idx]
        placed = False
        for g in range(b):
            gg = (idx + g) % b
            if i not in used[gg] and j not in used[gg]:
                groups[gg].append((i, j))
                used[gg].update((i, j))
                placed = True
                break
        if not placed:  # degenerate tiny-m case: widen slot 0 beyond a matching
            groups[idx % b].append((i, j))
            used[idx % b].update((i, j))
    mats = []
    for grp in groups:
        adj = np.zeros((m, m), dtype=bool)
        for (i, j) in grp:
            adj[i, j] = adj[j, i] = True
        mats.append(metropolis_weights(adj))
    eta = min(float(w[w > 1e-12].min()) for w in mats)
    return MixingSchedule(matrices=tuple(mats), b=b, eta=eta,
                          name=f"bring{m}_b{b}")


def random_b_connected_schedule(m: int, b: int, p_keep: float = 0.5,
                                seed: "int | np.random.Generator" = 0,
                                ) -> MixingSchedule:
    """Random time-varying graphs: each slot keeps a random subset of a base
    connected graph's edges; every b-th slot inserts the full ring to
    guarantee b-connectivity.  Metropolis weights keep double stochasticity.

    ``seed`` may be an int or an ``np.random.Generator`` (the latter keeps
    schedule draws on a stream disjoint from scenario-event streams).
    """
    rng = _as_rng(seed)
    mats = []
    for t in range(b):
        adj = np.zeros((m, m), dtype=bool)
        if t == b - 1:
            for i in range(m):
                adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
        else:
            for i in range(m):
                j = (i + 1) % m
                if rng.random() < p_keep:
                    adj[i, j] = adj[j, i] = True
        mats.append(metropolis_weights(adj))
    eta = min(float(w[w > 1e-12].min()) for w in mats)
    return MixingSchedule(matrices=tuple(mats), b=b, eta=eta,
                          name=f"rand{m}_b{b}")


# ---------------------------------------------------------------------------
# Analysis helpers
# ---------------------------------------------------------------------------

def is_doubly_stochastic(w: np.ndarray, atol: float = 1e-9) -> bool:
    m = w.shape[0]
    ones = np.ones(m)
    return (np.all(w >= -atol)
            and np.allclose(w @ ones, ones, atol=atol)
            and np.allclose(w.T @ ones, ones, atol=atol))


def second_largest_singular_value(w: np.ndarray) -> float:
    s = np.linalg.svd(w, compute_uv=False)
    return float(s[1]) if len(s) > 1 else 0.0


def spectral_gap(w: np.ndarray) -> float:
    """1 - |sigma_2(W)|; larger gap → faster consensus."""
    return 1.0 - second_largest_singular_value(w)


def lemma1_constants(schedule: MixingSchedule) -> tuple[float, float]:
    """Lemma 1 constants (Gamma, gamma): |phi_ij(l,g) - 1/m| <= Gamma*gamma^{g-l}."""
    m = schedule.m
    b0 = (m - 1) * schedule.b
    eta = schedule.eta
    gamma = 1.0 - eta ** b0
    big_gamma = 2.0 * (1.0 + eta ** (-b0))
    return big_gamma, gamma


def phi_product(mats: Sequence[np.ndarray]) -> np.ndarray:
    """W^g ... W^l for mats = [W^l, ..., W^g]."""
    out = np.eye(mats[0].shape[0])
    for w in mats:
        out = w @ out
    return out


def consensus_distance(x_stacked) -> float:
    """Mean L2 distance of node copies from their average (host metric)."""
    x = np.asarray(x_stacked)
    xbar = x.mean(axis=0, keepdims=True)
    return float(np.mean(np.linalg.norm((x - xbar).reshape(x.shape[0], -1), axis=1)))
