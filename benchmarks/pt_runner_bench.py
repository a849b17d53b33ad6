"""The port's runner bench: the counterpart of
``benchmarks/runner_bench.py``.

    python -m benchmarks.pt_runner_bench [--device cuda|cpu] [--scale S]
    python -m benchmarks.pt_runner_bench --json [PATH]
    python -m benchmarks.pt_run --only runner [--device cpu]

Times the same algorithms on the paper's logistic regression (adult_like at
``--scale``, m = 8) through ``runner.run``:

* ``resident``: DSPG for 600 steps and DPSVRG for 10 outer rounds on the
  b=2 ring, each through the host loop, ``scan=True`` (record windows drawn
  on the host, run as the resident pieces), resident with host sampling
  and resident with device sampling (``sampling="device"``).  Asserts each
  path's transfer ledger (resident (1, 1); scan one upload a chunk; the
  host loop one a step) and holds the host, scan and resident histories to
  each other (objective rtol 1e-4 / atol 1e-6, consensus rtol 1e-3), and
  the device-sampled run to the host-sampled one's envelope (final
  objectives within a third of the descent);
* ``backends``: DPSVRG (k_max = 2) on the 8-node b=1 ring through the
  dense, banded and compressed transports, resident: ms a step and wire
  bytes a step from the transport's own ``bytes_per_step``; and through
  ``ppermute`` on 4 ranks (one node a rank, so the 4-node b=1 ring, as
  the reference times it on a 4-device mesh), its 8-ring bytes from the
  banded accounting it shares;
* ``graphs``: DPSVRG with one record a round (``record_every=0``), its
  growing rounds cut into power-of-two pieces: the pieces (CUDA graphs on
  the card) the scan path builds (``runner.scan_executable_count``) and a
  resident run's ``graphs_built``, against the distinct round lengths;
* ``train``: ``trainer.train_loop`` at a small LM's shape (1 layer, d_model
  16, 4 nodes, 300 DPSVRG steps), host loop against resident with host
  and with device sampling; asserts the trainer's ledger and holds the
  host and resident losses to each other (rtol 1e-4 / atol 1e-5).

* ``shard_stats``: on 4 ranks, the 8-cell λ × seed DPSVRG sweep with its
  cells split over the ranks (``shard="cells"``) against the same sweep
  batched on one rank, a 32-node resident DSPG run with its node axis
  split (``shard="nodes"``, 8 rows a rank) against the unsharded run, and
  the ``compressed(ppermute)`` wire figures (per-link maps summing exactly
  to ``bytes_per_step`` at 4 and 3 bits, and a sharded run's bytes equal
  to the unsharded ``compressed(dense)`` run's).  Histories are held at
  rtol 1e-4 / atol 1e-6.

The ranks (``core.spmd.spawn``) run over gloo on the CPU and on one card
(host-staged between ranks that share it), over NCCL with a card a rank
(``spmd.backend_for``); ``wire`` names it.  With ranks sharing one card, their
ms a step measure time-slicing and host staging, not a speed-up.
``--json`` MERGES the stats as a ``"runner"`` section into PATH (default
``BENCH_torch.json``).  Runs on the CUDA device unless given ``--device
cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, graphs, prox, runner, \
    schedules, spmd, sweep, transport
from repro_torch.core.exec_spec import ExecSpec

DSPG_STEPS = 600
DSPG_RECORD = 100
TRAIN_STEPS = 300
ITERS = 3          # timed runs a row, after one warm-up; the best counts
LEFT_OUT: dict = {}
MESH_RANKS = 4
MESH_TIMEOUT = 600.0
SWEEP_GRID = {"lam": [0.001, 0.003, 0.01, 0.1], "seed": [0, 1]}
NODES_PER_RANK = 8
SHARD_DSPG_STEPS = 200
HIST_TOL = dict(rtol=1e-4, atol=1e-6)
PATHS = {
    "host": dict(),
    "scan": dict(scan=True),
    "resident": dict(resident=True),
    "resident_device_sampling": dict(resident=True, sampling="device"),
}


def _problem(scale: float, device):
    data, _, h, x0, d = common.setup_problem("adult_like", scale,
                                             device=device)
    return algorithm.Problem(common.logreg_loss, h, x0, data), int(d)


def _dpsvrg(problem, num_outer: int = 10, k_max=None):
    return algorithm.dpsvrg_algorithm(problem, dpsvrg.DPSVRGHyperParams(
        alpha=0.2, beta=1.2, n0=4, num_outer=num_outer, k_max=k_max))


def _dspg(problem):
    return algorithm.dspg_algorithm(
        problem, dpsvrg.DSPGHyperParams(alpha0=0.2), num_steps=DSPG_STEPS)


def _ledger(res) -> list:
    return [int(res.extras["transfers_h2d"]),
            int(res.extras["transfers_d2h"])]


def _path_rows(name, make, problem, sched, every, device, iters) -> dict:
    """One algorithm through the four paths: ms a step, ledgers, and the
    histories held to each other."""
    runs, ms = {}, {}
    for path, kw in PATHS.items():
        spec = dict(kw, gossip="dense", device=str(device))
        us = common._time_run(make(), problem, sched, record_every=every,
                              iters=iters, **spec)
        runs[path] = runner.run(make(), problem, sched, ExecSpec(**spec),
                                seed=0, record_every=every)
        ms[path] = us / 1e3 / int(runs[path].history.steps[-1])
    host, scan, res, dev = (runs[p] for p in PATHS)
    chunks = len(runs["scan"].history.steps) - 1
    assert _ledger(res) == _ledger(dev) == [1, 1], (name, _ledger(res))
    assert _ledger(scan)[0] >= chunks, (name, _ledger(scan))
    assert _ledger(host)[0] >= int(host.history.steps[-1]), _ledger(host)
    for other in (scan, res):
        np.testing.assert_allclose(host.history.objective,
                                   other.history.objective,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(host.history.consensus,
                                   other.history.consensus,
                                   rtol=1e-3, atol=1e-6)
    obj, dobj = res.history.objective, dev.history.objective
    descent = obj[0] - obj[-1]
    assert descent > 0 and abs(dobj[-1] - obj[-1]) < descent / 3, \
        (name, obj[-1], dobj[-1])
    return {
        "algorithm": name, "steps": int(res.history.steps[-1]),
        "record_every": every,
        **{f"{p}_ms_per_step": ms[p] for p in PATHS},
        "speedup_resident_vs_host": ms["host"] / ms["resident"],
        "speedup_resident_vs_scan": ms["scan"] / ms["resident"],
        "device_vs_host_sampling": ms["resident_device_sampling"]
        / ms["resident"],
        "transfers": {p: _ledger(runs[p]) for p in PATHS},
        "history_max_abs_diff": float(np.max(np.abs(
            host.history.objective - res.history.objective))),
        "objective_last": {p: float(runs[p].history.objective[-1])
                           for p in PATHS},
    }


def resident_stats(scale: float = 0.02, device="cuda"):
    """Host vs scan vs resident (host and device sampling): DSPG 600 steps
    and DPSVRG 10 outer rounds on the b=2 ring."""
    problem, d = _problem(scale, device)
    sched = graphs.b_connected_ring_schedule(8, b=2, seed=0)
    out = {"param_dim": d, "scale": scale, "schedule": "ring8_b2"}
    out["dspg600"] = _path_rows("dspg", lambda: _dspg(problem), problem,
                                sched, DSPG_RECORD, device, ITERS)
    out["dpsvrg10"] = _path_rows("dpsvrg", lambda: _dpsvrg(problem),
                                 problem, sched, 0, device, ITERS)
    return out


def backend_stats(scale: float = 0.02, device="cuda"):
    """ms a step and wire bytes a step of each one-device transport:
    DPSVRG (k_max = 2) on the 8-node b=1 ring, resident."""
    problem, d = _problem(scale, device)
    sched = graphs.b_connected_ring_schedule(8, b=1, seed=0)
    stats = {}
    for name in ("dense", "banded", "compressed"):
        spec = dict(resident=True, gossip=name, device=str(device))
        us = common._time_run(_dpsvrg(problem, 8, 2), problem, sched,
                              record_every=0, iters=ITERS, **spec)
        res = runner.run(_dpsvrg(problem, 8, 2), problem, sched,
                         ExecSpec(**spec), seed=0, record_every=0)
        steps = int(res.history.steps[-1])
        assert _ledger(res) == [1, 1], (name, _ledger(res))
        stats[name] = {"ms_per_step": us / 1e3 / steps,
                       "wire_bytes_per_step":
                           int(res.extras["wire_bytes"][-1]) / steps,
                       "objective_last": float(res.history.objective[-1])}
    np.testing.assert_allclose(stats["banded"]["objective_last"],
                               stats["dense"]["objective_last"], rtol=1e-4)
    return {"schedule": "ring8_b1", "algorithm": "dpsvrg_kmax2",
            "param_dim": d, "scale": scale, "backends": stats}


# ---------------------------------------------------------------------------
# Rows across ranks: ppermute, shard="cells", shard="nodes"
# ---------------------------------------------------------------------------

def _sweep_build(scale, device):
    data, _, _, x0, _ = common.setup_problem("adult_like", scale,
                                             device=device)
    hp = dpsvrg.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4, num_outer=8,
                                  k_max=2)

    def build(lam=0.01):
        problem = algorithm.Problem(common.logreg_loss, prox.l1(lam), x0,
                                    data)
        return algorithm.dpsvrg_algorithm(problem, hp), problem

    return build


def _shard_dspg(problem):
    return algorithm.dspg_algorithm(
        problem, dpsvrg.DSPGHyperParams(alpha0=0.2),
        num_steps=SHARD_DSPG_STEPS)


def _timed_sweep(build, sched, spec, device, iters: int) -> float:
    sweep.run_sweep(build, SWEEP_GRID, sched, spec, record_every=0)
    common.sync(device)
    best = float("inf")
    for _ in range(iters):
        _, us = common.timed(lambda: sweep.run_sweep(
            build, SWEEP_GRID, sched, spec, record_every=0), device)
        best = min(best, us)
    return best


def _history(res) -> dict:
    return {"objective": np.asarray(res.history.objective),
            "steps": np.asarray(res.history.steps),
            "wire_bytes": np.asarray(res.extras["wire_bytes"]),
            "transfers": _ledger(res), "wire": res.extras.get("wire")}


def mesh_rank_rows(scale: float, device: str, iters: int) -> dict:
    """The rows across ranks, run on one rank of a group (every rank runs
    the same; ``spmd.spawn`` starts them), each timed as the best of
    ``iters`` runs after a warm-up."""
    world = spmd.dist.get_world_size()
    out = {}
    # ppermute: one node a rank, DPSVRG (k_max = 2) on the world-node ring
    data, _, h, x0, _ = common.setup_problem("adult_like", scale, m=world,
                                             device=device)
    p4 = spmd.local_problem(algorithm.Problem(common.logreg_loss, h, x0,
                                              data))
    ring = graphs.b_connected_ring_schedule(world, b=1, seed=0)
    spec = dict(resident=True, gossip="ppermute", device=device)
    us = common._time_run(_dpsvrg(p4, 8, 2), p4, ring, record_every=0,
                          iters=iters, **spec)
    res = runner.run(_dpsvrg(p4, 8, 2), p4, ring, ExecSpec(**spec), seed=0,
                     record_every=0)
    out["ppermute"] = dict(_history(res), us=us)
    # shard="cells": the 8-cell sweep, 8 / world cells a rank
    sched = graphs.b_connected_ring_schedule(8, b=1, seed=0)
    cells = ExecSpec(resident=True, gossip="dense", shard="cells",
                     device=device)
    build = _sweep_build(scale, device)
    us = _timed_sweep(build, sched, cells, device, iters)
    res = sweep.run_sweep(build, SWEEP_GRID, sched, cells, record_every=0)
    out["cells"] = dict(_history(res), us=us)
    # shard="nodes": NODES_PER_RANK rows a rank
    m = NODES_PER_RANK * world
    data, _, h, x0, _ = common.setup_problem("adult_like", scale, m=m,
                                             device=device)
    pm = spmd.local_problem(algorithm.Problem(common.logreg_loss, h, x0,
                                              data))
    ring_m = graphs.b_connected_ring_schedule(m, b=1, seed=0)
    spec = dict(resident=True, gossip="dense", shard="nodes", device=device)
    us = common._time_run(_shard_dspg(pm), pm, ring_m, record_every=50,
                          iters=iters, **spec)
    res = runner.run(_shard_dspg(pm), pm, ring_m, ExecSpec(**spec), seed=0,
                     record_every=50)
    out["nodes"] = dict(_history(res), us=us, m=m)
    # compressed(ppermute): per-link maps, and a sharded run's bytes
    algo = algorithm.loopless_dpsvrg_algorithm(p4, 0.2, 100,
                                               snapshot_prob=0.1)
    pc = transport.node_param_count(p4.x0)
    links = {}
    for bits in (4, 3):
        be = transport.CompressedBackend(inner="ppermute", bits=bits)
        aux = be.prepare(ring, algo.meta)
        phi = be.phi_for(aux, algo.meta.slot_start, 2)
        links[f"bits{bits}"] = {
            "bytes_per_step": int(be.bytes_per_step(aux, phi, pc)),
            "link_sum": int(sum(be.bytes_per_link(aux, phi, pc).values())),
            "links": len(be.bytes_per_link(aux, phi, pc))}
    res = runner.run(algo, p4, ring, ExecSpec(
        resident=True, shard="nodes", device=device,
        gossip=transport.CompressedBackend(inner="ppermute", bits=4)),
        seed=0, record_every=25)
    out["compressed_ppermute"] = dict(_history(res), links=links)
    return out


def mesh_stats(scale: float = 0.02, device="cuda") -> dict:
    """Run the rows across ``MESH_RANKS`` ranks and hold each to its
    unsharded twin on this process's device."""
    device = common.require_device(device)
    kind = device.type
    t0 = time.perf_counter()
    ranks = spmd.spawn(mesh_rank_rows, MESH_RANKS,
                       backend=spmd.backend_for(device, MESH_RANKS),
                       device=kind,
                       args=(scale, kind, ITERS), timeout=MESH_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    r = ranks[0]
    for other in ranks[1:]:
        for key in ("ppermute", "cells", "nodes", "compressed_ppermute"):
            np.testing.assert_array_equal(other[key]["objective"],
                                          r[key]["objective"])
    world = MESH_RANKS
    # the unsharded twins
    data, _, h, x0, _ = common.setup_problem("adult_like", scale, m=world,
                                             device=device)
    p4 = algorithm.Problem(common.logreg_loss, h, x0, data)
    ring = graphs.b_connected_ring_schedule(world, b=1, seed=0)
    twin = runner.run(_dpsvrg(p4, 8, 2), p4, ring, ExecSpec(
        resident=True, gossip="dense", device=str(device)), seed=0,
        record_every=0)
    np.testing.assert_allclose(r["ppermute"]["objective"],
                               twin.history.objective, **HIST_TOL)
    steps = int(r["ppermute"]["steps"][-1])
    ppermute = {
        "ms_per_step": r["ppermute"]["us"] / 1e3 / steps,
        "timed_on": f"ring{world}", "ranks": world,
        "wire": r["ppermute"]["wire"],
        "ring4_wire_bytes_per_step": int(r["ppermute"]["wire_bytes"][-1])
        / steps,
        "dense_ring4_wire_bytes_per_step":
            int(twin.extras["wire_bytes"][-1]) / steps,
        "transfers": r["ppermute"]["transfers"],
        "history_max_abs_diff": float(np.max(np.abs(
            r["ppermute"]["objective"] - twin.history.objective)))}

    sched = graphs.b_connected_ring_schedule(8, b=1, seed=0)
    build = _sweep_build(scale, device)
    base = ExecSpec(resident=True, gossip="dense", device=str(device))
    us_plain = _timed_sweep(build, sched, base, device, ITERS)
    plain = sweep.run_sweep(build, SWEEP_GRID, sched, base, record_every=0)
    np.testing.assert_allclose(r["cells"]["objective"],
                               plain.history.objective, **HIST_TOL)
    np.testing.assert_array_equal(r["cells"]["wire_bytes"],
                                  plain.extras["wire_bytes"])
    cells_n = len(plain.grid)
    cell_steps = int(plain.history.steps[-1, 0])

    m = NODES_PER_RANK * world
    data, _, h, x0, _ = common.setup_problem("adult_like", scale, m=m,
                                             device=device)
    pm = algorithm.Problem(common.logreg_loss, h, x0, data)
    ring_m = graphs.b_connected_ring_schedule(m, b=1, seed=0)
    spec = dict(resident=True, gossip="dense", device=str(device))
    us_nodes_plain = common._time_run(_shard_dspg(pm), pm, ring_m,
                                      record_every=50, iters=ITERS, **spec)
    nodes_plain = runner.run(_shard_dspg(pm), pm, ring_m, ExecSpec(**spec),
                             seed=0, record_every=50)
    np.testing.assert_allclose(r["nodes"]["objective"],
                               nodes_plain.history.objective, **HIST_TOL)
    np.testing.assert_array_equal(r["nodes"]["wire_bytes"],
                                  nodes_plain.extras["wire_bytes"])

    cp = r["compressed_ppermute"]
    loopless = algorithm.loopless_dpsvrg_algorithm(p4, 0.2, 100,
                                                   snapshot_prob=0.1)
    cdense = runner.run(loopless, p4, ring, ExecSpec(
        resident=True, device=str(device),
        gossip=transport.CompressedBackend(inner="dense", bits=4)),
        seed=0, record_every=25)
    for entry in cp["links"].values():
        assert entry["link_sum"] == entry["bytes_per_step"], cp["links"]
    for key in ("ppermute", "cells", "nodes", "compressed_ppermute"):
        assert r[key]["transfers"] == [1, 1], (key, r[key]["transfers"])
    shard = {
        "ranks": world, "wire": r["cells"]["wire"], "spawn_s": spawn_s,
        "cells_sweep8": {
            "cells": cells_n, "steps_per_cell": cell_steps,
            "batched_ms_per_step_per_cell":
                us_plain / 1e3 / (cell_steps * cells_n),
            "sharded_ms_per_step_per_cell":
                r["cells"]["us"] / 1e3 / (cell_steps * cells_n),
            "transfers": r["cells"]["transfers"],
            "history_max_abs_diff": float(np.max(np.abs(
                r["cells"]["objective"] - plain.history.objective)))},
        "nodes_dspg": {
            "m": m, "rows_per_rank": NODES_PER_RANK,
            "steps": SHARD_DSPG_STEPS,
            "unsharded_ms_per_step": us_nodes_plain / 1e3
            / SHARD_DSPG_STEPS,
            "sharded_ms_per_step": r["nodes"]["us"] / 1e3
            / SHARD_DSPG_STEPS,
            "transfers": r["nodes"]["transfers"],
            "history_max_abs_diff": float(np.max(np.abs(
                r["nodes"]["objective"] - nodes_plain.history.objective)))},
        "compressed_ppermute": dict(cp["links"], wire_bytes_equal=bool(
            np.array_equal(cp["wire_bytes"], cdense.extras["wire_bytes"])),
            sharded_vs_dense_max_abs_diff=float(np.max(np.abs(
                cp["objective"] - cdense.history.objective))))}
    assert shard["compressed_ppermute"]["wire_bytes_equal"], cp
    return {"ppermute": ppermute, "shard_stats": shard}


def graph_stats(scale: float = 0.02, device="cuda") -> dict:
    """Per-round chunks (``record_every=0``) of DPSVRG's growing rounds:
    the pieces the scan path builds and a resident run's CUDA graphs, at
    most log2(MAX_PIECE) + 1 a run whatever the round lengths."""
    problem, _ = _problem(scale, device)
    sched = graphs.b_connected_ring_schedule(8, b=2, seed=0)
    hp = dpsvrg.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4, num_outer=10,
                                  k_max=4)
    ks = schedules.inner_loop_lengths(hp.beta, hp.n0, hp.num_outer)
    runner.reset_executable_caches()
    algo = algorithm.dpsvrg_algorithm(problem, hp)
    _, scan_us = common.timed(lambda: runner.run(
        algo, problem, sched, ExecSpec(scan=True, gossip="dense",
                                       device=str(device)),
        seed=0, record_every=0), device)
    pieces = runner.scan_executable_count(algo)
    res, res_us = common.timed(lambda: runner.run(
        algorithm.dpsvrg_algorithm(problem, hp), problem, sched,
        ExecSpec(resident=True, gossip="dense", device=str(device)),
        seed=0, record_every=0), device)
    bound = int(np.log2(runner.MAX_PIECE)) + 1
    assert 1 <= pieces <= bound, pieces
    if torch.device(device).type == "cuda":
        assert 1 <= res.extras["graphs_built"] <= bound, res.extras
    return {"distinct_round_lengths": len(set(ks)),
            "steps": int(sum(ks)), "max_piece": runner.MAX_PIECE,
            "scan_pieces_built": pieces,
            "resident_graphs_built": int(res.extras["graphs_built"]),
            "resident_replays": int(res.extras["replays"]),
            "capture_s": float(res.extras["capture_s"]),
            "scan_cold_us": scan_us, "resident_cold_us": res_us}


def train_stats(device="cuda") -> dict:
    """Host loop vs resident LM training (host and device sampling) at a
    small LM's shape: 300 DPSVRG steps of a 1-layer d_model-16 decoder over
    4 nodes, records every 100 steps."""
    from repro_torch.data.loader import LMLoader
    from repro_torch.models.api import ModelConfig
    from repro_torch.train import trainer
    cfg = ModelConfig(name="bench-lm", arch_type="dense", num_layers=1,
                      d_model=16, num_heads=1, num_kv_heads=1, d_ff=32,
                      vocab_size=64)
    pr = prox.l1(1e-4)
    m, steps = 4, TRAIN_STEPS
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=20_000).astype(np.int32)
    sched = graphs.b_connected_ring_schedule(m, b=2, seed=0)
    tc = trainer.TrainerConfig(num_steps=steps, snapshot_every=steps // 3,
                               log_every=steps // 3, alpha=0.05,
                               consensus_rounds=2, seed=0)

    def run_once(resident, sampling="host"):
        ld = LMLoader(toks, num_nodes=m, per_node_batch=1, seq_len=8,
                      seed=1)
        return trainer.train_loop(cfg, pr, sched, ld, tc, exec=ExecSpec(
            resident=resident, sampling=sampling, device=str(device)))

    def timed(*args):
        run_once(*args)                 # warm-up
        best = float("inf")
        for _ in range(ITERS):
            _, us = common.timed(lambda: run_once(*args), device)
            best = min(best, us)
        return best

    t_host, t_res = timed(False), timed(True)
    t_dev = timed(True, "device")
    h_host, h_res = run_once(False), run_once(True)
    h_dev = run_once(True, "device")
    windows = len(h_res["step"])
    assert h_res["transfers"] == h_dev["transfers"] == \
        {"h2d": 1, "d2h": windows}, h_res["transfers"]
    assert h_host["transfers"] == {"h2d": steps, "d2h": windows}
    np.testing.assert_allclose(h_host["loss"], h_res["loss"], rtol=1e-4,
                               atol=1e-5)
    assert np.all(np.isfinite(h_dev["loss"]))
    return {
        "model": "lm1x16_v64", "algorithm": "dpsvrg", "steps": steps,
        "nodes": m, "per_node_batch": 1, "seq_len": 8,
        "log_windows": windows,
        "host_ms_per_step": t_host / 1e3 / steps,
        "resident_ms_per_step": t_res / 1e3 / steps,
        "resident_device_sampling_ms_per_step": t_dev / 1e3 / steps,
        "speedup_resident_vs_host": t_host / t_res,
        "transfers": {"host": [h_host["transfers"]["h2d"],
                               h_host["transfers"]["d2h"]],
                      "resident": [h_res["transfers"]["h2d"],
                                   h_res["transfers"]["d2h"]]},
        "history_max_abs_diff": float(np.max(np.abs(
            np.array(h_host["loss"]) - np.array(h_res["loss"])))),
    }


def runner_stats(scale: float = 0.02, device="cuda") -> dict:
    device = common.require_device(device)
    out = {"device": str(device)}
    out["resident"] = resident_stats(scale, device)
    out.update(backend_stats(scale, device))
    mesh = mesh_stats(scale, device)
    ppermute = mesh["ppermute"]
    # the 8-ring's bytes: ppermute shares banded's accounting
    ppermute["wire_bytes_per_step"] = \
        out["backends"]["banded"]["wire_bytes_per_step"]
    out["backends"]["ppermute"] = ppermute
    out["shard_stats"] = mesh["shard_stats"]
    out["graphs"] = graph_stats(scale, device)
    out["train"] = train_stats(device)
    out["left_out"] = dict(LEFT_OUT)
    return out


def run(scale: float = 0.02, device="cuda"):
    """The bench as ``name,us_per_call,derived`` rows."""
    st = runner_stats(scale, device)
    rows = []
    for key in ("dspg600", "dpsvrg10"):
        r = st["resident"][key]
        steps = r["steps"]
        for path in PATHS:
            rows.append(common.Row(
                f"runner/{r['algorithm']}_{path}",
                r[f"{path}_ms_per_step"] * steps * 1e3,
                f"ms/step={r[f'{path}_ms_per_step']:.4f} "
                f"h2d/d2h={r['transfers'][path]}", r))
    for name, entry in st["backends"].items():
        ms = entry["ms_per_step"]
        derived = (f"ms/step={ms:.4f} wire_bytes/step="
                   f"{entry['wire_bytes_per_step']:.0f}")
        if name == "ppermute":
            derived += (f" (timed on {entry['timed_on']}, "
                        f"{entry['ranks']} ranks, wire={entry['wire']})")
        rows.append(common.Row(f"runner/backend_{name}", ms * 1e3, derived,
                               entry))
    g = st["graphs"]
    rows.append(common.Row(
        "runner/dpsvrg_scan_record_every_0", g["scan_cold_us"],
        f"{g['scan_pieces_built']} pieces (resident: "
        f"{g['resident_graphs_built']} graphs) for "
        f"{g['distinct_round_lengths']} distinct K_s", g))
    t = st["train"]
    for path in ("host", "resident", "resident_device_sampling"):
        rows.append(common.Row(
            f"trainer/lm_{path}_{t['steps']}steps",
            t[f"{path}_ms_per_step"] * t["steps"] * 1e3,
            f"ms/step={t[f'{path}_ms_per_step']:.4f}", t))
    sh = st["shard_stats"]
    c, nd = sh["cells_sweep8"], sh["nodes_dspg"]
    rows.append(common.Row(
        "runner/shard_cells_sweep8",
        c["sharded_ms_per_step_per_cell"] * 1e3,
        f"ms/step/cell sharded={c['sharded_ms_per_step_per_cell']:.4f} "
        f"batched={c['batched_ms_per_step_per_cell']:.4f} "
        f"ranks={sh['ranks']} wire={sh['wire']}", c))
    rows.append(common.Row(
        f"runner/shard_nodes_dspg{nd['m']}",
        nd["sharded_ms_per_step"] * nd["steps"] * 1e3,
        f"ms/step sharded={nd['sharded_ms_per_step']:.4f} "
        f"unsharded={nd['unsharded_ms_per_step']:.4f} "
        f"ranks={sh['ranks']} wire={sh['wire']}", nd))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--json", nargs="?", const="BENCH_torch.json",
                    default=None, metavar="PATH",
                    help="MERGE the stats as a 'runner' section into PATH "
                         "(default BENCH_torch.json), keeping its other "
                         "sections")
    args = ap.parse_args(argv)
    if args.json:
        out = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                out = json.load(f)
        out["runner"] = runner_stats(args.scale, args.device)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json} (runner section, device "
              f"{out['runner']['device']})")
        for key in ("dspg600", "dpsvrg10"):
            r = out["runner"]["resident"][key]
            print(f"  {key:9s} " + " ".join(
                f"{p}={r[f'{p}_ms_per_step']:.4f}" for p in PATHS)
                + " ms/step")
    else:
        print("name,us_per_call,derived")
        for r in run(args.scale, args.device):
            print(f"{r.name},{r.us_per_call:.1f},{r.derived}")


if __name__ == "__main__":
    main()
