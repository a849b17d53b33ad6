"""BEYOND-PAPER: non-IID partitions under adversarial network scenarios.
The port of ``benchmarks/beyond_noniid.py``: the same scenario matrix,
hyperparameters and derived columns.

The paper partitions data IID and gossips over benign periodic schedules.
Real decentralized deployments are heterogeneous twice over: each node's
local distribution differs, AND the network misbehaves — links drop, nodes
churn, payloads arrive stale.  This benchmark runs the full {topology x
failure x compression x algorithm} scenario matrix through
``repro_torch.scenarios.run_matrix`` — every (topology, failure, seed)
plane is ONE batched resident program — on a heterogeneous adult_like
partition (het = 0.7), and reports per-scenario optimality gaps plus the
convergence-vs-wire-bytes Pareto frontier.
"""

from __future__ import annotations

import collections

import torch

from . import pt_common as common
from repro_torch import scenarios
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, gossip, graphs, prox
from repro_torch.data import synthetic

M = 8
STEPS = 120
HETEROGENEITY = 0.7


def _topologies(m: int) -> dict:
    return {
        "ring": graphs.static_schedule(graphs.ring_matrix(m), name="ring"),
        "bconn": graphs.b_connected_ring_schedule(m, b=1),
    }


def _failures() -> dict:
    return {
        "none": [],
        "links30": [scenarios.LinkFailures(0.3)],
        "churn20": [scenarios.NodeChurn(0.2, dwell=5)],
        "stale3+strag": [scenarios.StaleGossip(3), scenarios.Stragglers(2.0)],
    }


def setup(scale: float, device="cuda"):
    """-> (problem, F(x*)): adult_like at ``scale``, partitioned over M
    nodes at heterogeneity 0.7, on ``device``."""
    device = common.require_device(device)
    ds = synthetic.make_paper_dataset("adult_like", scale=scale)
    data = params_from_numpy(synthetic.partition_per_node(
        ds, M, heterogeneity=HETEROGENEITY), device)
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
    h = prox.l1(0.01)
    fs = common.f_star(flat, h, ds.dim)
    x0 = gossip.stack_tree(torch.zeros(ds.dim, device=device), M)
    return common.make_problem(data, h, x0), fs


def algorithms(alpha: float = 0.2, steps: int = STEPS) -> dict:
    return {
        "loopless_dpsvrg": lambda p: algorithm.loopless_dpsvrg_algorithm(
            p, alpha, steps, snapshot_prob=0.1),
        "dvr": lambda p: algorithm.dvr_algorithm(
            p, alpha, steps, rho=0.7, snapshot_prob=0.1),
        "gt_svrg": lambda p: algorithm.gt_svrg_algorithm(
            p, alpha / 2, 4, steps // 4),
    }


def matrix(problem, device="cuda", alpha: float = 0.2,
           batched: bool = True, steps: int = STEPS) -> scenarios.MatrixResult:
    """The scenario matrix: 2 topologies x 4 failures x 2 compressions x 3
    algorithms, one batched program per (algorithm, compression, transport
    spec), ``steps`` steps a cell; ``batched=False`` runs the cells as
    sequential resident runs."""
    return scenarios.run_matrix(
        problem, _topologies(M), _failures(), algorithms(alpha, steps),
        compressions=(None, 8), seeds=(0,), record_every=steps,
        scenario_seed=0, batched=batched, device=device)


def rows(res: scenarios.MatrixResult, fs: float) -> list:
    """One row per (failure, compression): per-algorithm gaps averaged over
    topologies, and the wire bytes of the cheapest cell in the slice; then
    the frontier's first four entries."""
    by_slice = collections.defaultdict(list)
    for r in res.rows:
        by_slice[(r.failure, r.compression)].append(r)
    out = []
    for (failure, compression), cells in sorted(by_slice.items()):
        gaps = {}
        for r in cells:
            gaps.setdefault(r.algorithm, []).append(r.objective - fs)
        mean = {name: sum(v) / len(v) for name, v in sorted(gaps.items())}
        derived = " ".join(f"gap_{name}={g:.5f}" for name, g in mean.items())
        wire = min(r.wire_bytes for r in cells)
        out.append(common.Row(
            f"beyond/scenario_{failure}_{compression}", 0.0,
            f"{derived} min_wire={wire}", {"gaps": mean, "min_wire": wire}))

    front = scenarios.pareto_frontier(res.rows)
    out.append(common.Row(
        "beyond/frontier", 0.0,
        " ".join(f"{r.algorithm}/{r.compression}/{r.topology}/{r.failure}"
                 f"@{r.wire_bytes}B" for r in front[:4]),
        {"frontier": [r._asdict() for r in front[:4]]}))
    return out


def run(scale: float = 0.02, alpha: float = 0.2, device="cuda",
        batched: bool = True):
    problem, fs = setup(scale, device)
    return rows(matrix(problem, device, alpha, batched), fs)
