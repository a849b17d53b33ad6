"""Scenario matrix driver: {topology x failure x compression x algorithm}
grids as batched resident sweeps, emitting a convergence-vs-wire-bytes
frontier.  The port of ``repro.scenarios.matrix``.

The driver replaces hand-rolled nested benchmark loops with ``run_sweep``
programs:

* The **topology x failure x seed** plane of the grid is DATA — every
  (topology, schedule-level failure) combination becomes one wrapped
  schedule on ``run_sweep``'s reserved ``"schedule"`` axis, so the whole
  plane runs as ONE batched device-resident program with one staging step
  and one history pull (the schedules share the structure-free dense wire
  format; per-cell degraded gossip products ride the staged inputs).
* The **algorithm**, **compression**, and **transport-model** axes are
  STRUCTURE — different state trees / wire formats cannot share one
  vmapped program (the same constraint ``core.sweep`` enforces for every
  batched sweep) — so the driver groups cells by
  ``(algorithm, compress_bits, delay, straggler_p)`` and runs one batched
  program per group.

Every group's transfer ledger is returned (``MatrixResult.groups``) so
tests can assert the (1, 1) property per program; rows are deterministic
under fixed seeds because every scenario event is a counter-based
function of ``(scenario_seed, t)``.  Runs execute on ``device``, the CUDA
device unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np

from ..core import exec_spec as exec_spec_lib, graphs, sweep as sweep_lib

from . import models as models_lib
from .transports import ScenarioBackend

__all__ = ["MatrixRow", "MatrixResult", "run_matrix", "pareto_frontier",
           "format_table"]


class MatrixRow(NamedTuple):
    """One cell's outcome: final objective vs total wire bytes."""
    topology: str
    failure: str
    compression: str               # "f32" or e.g. "int8"
    algorithm: str
    seed: int
    objective: float               # final recorded objective
    wire_bytes: int                # cumulative over the run
    comm_rounds: int
    steps: int


@dataclasses.dataclass(frozen=True)
class MatrixResult:
    """``rows`` in deterministic grid order; ``groups`` one entry per
    batched program: {algorithm, compression, transport, cells,
    transfers_h2d, transfers_d2h, sweep}."""
    rows: list
    groups: list

    def row(self, topology: str, failure: str, compression: str,
            algorithm: str, seed: int) -> MatrixRow:
        for r in self.rows:
            if (r.topology, r.failure, r.compression, r.algorithm,
                    r.seed) == (topology, failure, compression, algorithm,
                                seed):
                return r
        raise KeyError((topology, failure, compression, algorithm, seed))


def _bits_label(bits: "int | None") -> str:
    return "f32" if bits is None else f"int{bits}"


def run_matrix(problem,
               topologies: Mapping[str, graphs.MixingSchedule],
               failures: Mapping[str, Sequence],
               algorithms: Mapping[str, Callable],
               *,
               compressions: Sequence = (None,),
               seeds: Sequence[int] = (0,),
               gossip: Any = "dense",
               record_every: int = 10,
               scenario_seed: int = 0,
               batched: bool = True,
               sampling: str = "host",
               mesh=None,
               shard: "str | None" = None,
               device: Any = "cuda") -> MatrixResult:
    """Expand and run the scenario matrix.

    problem:      the shared :class:`~repro_torch.core.algorithm.Problem`
                  (one dataset — batched programs share it).
    topologies:   ``{name: MixingSchedule}``.
    failures:     ``{name: [scenario models...]}`` — an empty list is the
                  zero-intensity baseline scenario.  Schedule-level models
                  (LinkFailures/NodeChurn) vary WITHIN a batched program;
                  transport-level models (StaleGossip/Stragglers) define
                  the program grouping.
    algorithms:   ``{name: factory(problem) -> Algorithm}``.
    compressions: int bit widths (None = uncompressed f32 payloads).
    gossip:       inner wire format under the scenario transport
                  ("dense" batches across arbitrary topologies).
    batched:      False falls back to sequential resident runs per cell
                  (same rows, no shared program — the equivalence
                  baseline).
    mesh, shard:  ``shard="cells"`` splits each batched program's cells
                  over ``mesh``'s ``"cells"`` dim (by default every rank of
                  the default group; see ``ExecSpec.shard``), every rank
                  making the same call; each program's cell count must
                  split evenly over it.
    device:       where every program runs (``problem``'s tensors lie
                  there); ``"cuda"`` unless the caller asks for ``"cpu"``.
    """
    # one spec for every program, validated before any run
    spec = exec_spec_lib.ExecSpec(resident=True, sampling=sampling,
                                  gossip="dense", mesh=mesh, shard=shard,
                                  device=device)
    failures = {name: models_lib._check_models(mdls)
                for name, mdls in failures.items()}
    topo_items = list(topologies.items())
    seeds = list(seeds)

    # group failures by their transport spec: one batched program per
    # (algorithm, bits, transport spec)
    by_tspec: dict = {}
    for fname, fmodels in failures.items():
        by_tspec.setdefault(models_lib.transport_spec(fmodels),
                            []).append((fname, fmodels))

    results: dict = {}
    groups: list = []
    for algo_name, factory in algorithms.items():
        def build(_factory=factory):
            return _factory(problem), problem

        for bits in compressions:
            for (delay, straggler_p), fitems in by_tspec.items():
                labels = []
                schedules = []
                for tname, tsched in topo_items:
                    for fname, fmodels in fitems:
                        labels.append((tname, fname))
                        schedules.append(models_lib.wrap_schedule(
                            tsched, fmodels, seed=scenario_seed))
                backend = ScenarioBackend(
                    inner=gossip, delay=delay, straggler_p=straggler_p,
                    seed=scenario_seed, compress_bits=bits)
                res = sweep_lib.run_sweep(
                    build, {"schedule": schedules, "seed": seeds},
                    exec=spec.replace(gossip=backend),
                    record_every=record_every, batched=batched)
                groups.append({
                    "algorithm": algo_name,
                    "compression": _bits_label(bits),
                    "transport": {"delay": delay,
                                  "straggler_p": straggler_p},
                    "cells": len(res.grid),
                    "transfers_h2d": res.extras["transfers_h2d"],
                    "transfers_d2h": res.extras["transfers_d2h"],
                    "sweep": res,
                })
                # expand_grid is product over insertion order:
                # schedule-major, then seed
                i = 0
                for (tname, fname) in labels:
                    for seed in seeds:
                        cell = res.cell(i)
                        hist = cell.history
                        results[(algo_name, bits, tname, fname, seed)] = \
                            MatrixRow(
                                topology=tname, failure=fname,
                                compression=_bits_label(bits),
                                algorithm=algo_name, seed=seed,
                                objective=float(hist.objective[-1]),
                                wire_bytes=int(
                                    cell.extras["wire_bytes"][-1]),
                                comm_rounds=int(hist.comm_rounds[-1]),
                                steps=int(hist.steps[-1]))
                        i += 1

    rows = [results[(a, b, t, f, s)]
            for a in algorithms for b in compressions
            for t, _ in topo_items for f in failures for s in seeds]
    return MatrixResult(rows=rows, groups=groups)


def pareto_frontier(rows: Sequence[MatrixRow]) -> list:
    """The convergence-vs-wire-bytes Pareto set: rows not dominated by any
    other row (lower wire bytes AND lower-or-equal objective, or vice
    versa).  Sorted by wire bytes ascending."""
    ordered = sorted(rows, key=lambda r: (r.wire_bytes, r.objective))
    front: list = []
    best = np.inf
    for r in ordered:
        if r.objective < best:
            front.append(r)
            best = r.objective
    return front


def format_table(rows: Sequence[MatrixRow],
                 frontier: bool = True) -> str:
    """Render rows as a fixed-width frontier table (`*` marks the
    convergence-vs-wire-bytes Pareto set)."""
    front = set(map(id, pareto_frontier(rows))) if frontier else set()
    header = (f"{'topology':<14} {'failure':<16} {'compr':<6} "
              f"{'algorithm':<16} {'seed':>4} {'objective':>12} "
              f"{'wire_bytes':>12} {'rounds':>7}")
    lines = [header, "-" * len(header)]
    for r in sorted(rows, key=lambda x: (x.wire_bytes, x.objective)):
        mark = "*" if id(r) in front else " "
        lines.append(
            f"{r.topology:<14} {r.failure:<16} {r.compression:<6} "
            f"{r.algorithm:<16} {r.seed:>4} {r.objective:>12.6f} "
            f"{r.wire_bytes:>12} {r.comm_rounds:>7}{mark}")
    return "\n".join(lines)
