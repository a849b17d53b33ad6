"""The paper's decentralized path across ranks at full size: the runs of
``chip_smoke.py``'s mesh phase and the unsharded runs they are held to.

    python3 -c "import chip_smoke as c; c._build.build(c.SOURCES); \\
        c.mesh_phase()"

``cifar10_like`` at scale 1.0 (n = 50,000, d = 1,024), the paper's
hyper-parameters (``configs.paper_logreg``) on the b = 1 ring, DPSVRG cut to
``OUTER`` outer rounds (the main path runs 30) and DSPG over as many
steps.  ``RANKS`` ranks (``core.spmd.spawn``) each run, with every launch
count set to 0 before a run and read after it:

* m = 8, two nodes a rank (``shard="nodes"``): DPSVRG over the dense
  transport (the svrg step's ``q`` through ``svrg_step`` on the rank's
  rows, then the wire and the plain mix) and DSPG over the banded one
  (``q`` on the rank's rows, the all-gather, then each row's mix and prox
  through ``mix_prox``), ``kernel="auto"``;
* m = 4, one node a rank (``ppermute``): single-consensus DPSVRG (Fig. 3's
  ablation, so the offsets stay {0, +1, -1}: ``svrg_step``, the exchange,
  ``mix_prox``) and DSPG (the exchange, ``mix_prox``), ``kernel="auto"``;
  then
  ``compressed(ppermute)`` at int8, loopless DPSVRG over
  ``COMPRESSED_STEPS`` steps (after that a last-bit difference moves an
  int8 code, as the scenario phase finds);
* Fig. 1's 4-seed DPSVRG sweep on the dataset with ``shard="cells"``, one
  cell a rank, through the cell-batched ``fused_step``;
* ``svrg_step`` and ``mix_prox`` on random operands of the rank's rows,
  held to their plain versions;
* ``TRACE_STEPS`` DSPG steps over ``ppermute`` under ``torch.profiler``
  over NCCL, read by ``launch.roofline.collective_bytes`` (over gloo the
  same steps run untraced: no gloo event carries what the NCCL ones do,
  and the profiler's start on four ranks sharing a card costs seconds).

The parent runs each on the whole stack (``kernel="plain"``; ppermute's
twin on the banded transport, which has its accounting) and holds the
sharded histories and parameters at rtol 1e-4 / atol 1e-6, the int8
iterates alike, and the wire bytes exactly.  Ranks sharing one card run
over gloo, host-staged; with a card a rank, over NCCL
(``spmd.backend_for``).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from . import pt_common as common
from repro_torch.configs import paper_logreg
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, graphs, prox, runner, spmd, sweep, \
    transport
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
from repro_torch.kernels.fused_update import ops, ref

RANKS = 4
DATASET = "cifar10_like"
OUTER = 10
COMPRESSED_STEPS = 12
TRACE_STEPS = 2
FIG1_SEEDS = 4
TIMEOUT = 600.0
HIST_TOL = dict(rtol=1e-4, atol=1e-6)
CFG = paper_logreg.CONFIG
COUNTERS = ("launches", "launches_cells", "launches_svrg_step",
            "launches_mix_prox")

# name -> (m, gossip, algorithm, kernel, the unsharded twin's gossip)
RUNS = {
    "nodes_dense_dpsvrg": (8, "dense", "dpsvrg", "auto", "dense"),
    "nodes_banded_dspg": (8, "banded", "dspg", "auto", "banded"),
    "ppermute_dpsvrg": (4, "ppermute", "dpsvrg_single", "auto", "banded"),
    "ppermute_dspg": (4, "ppermute", "dspg", "auto", "banded"),
    "compressed_ppermute_int8": (4, ("ppermute", 8), "loopless", "plain",
                                 ("banded", 8)),
}


def dataset(scale: float):
    return synthetic.make_paper_dataset(DATASET, scale=scale, seed=0)


def problem(ds, m: int, device, rows: slice = slice(None), parts=None):
    """The paper's problem over m nodes, ``rows`` of them (only those are
    copied to the device); ``parts``: the dataset's partition over the m
    nodes, if already made."""
    if parts is None:
        parts = synthetic.partition_per_node(ds, m)
    parts = {k: v[rows] for k, v in parts.items()}
    data = params_from_numpy(parts, device)
    x0 = torch.zeros(parts["features"].shape[0], ds.dim, device=device)
    return algorithm.Problem(common.logreg_loss, prox.l1(CFG.lam), x0, data)


def _dpsvrg_hp(outer: int, **kw):
    return algorithm.DPSVRGHyperParams(alpha=CFG.alpha, beta=CFG.beta,
                                       n0=CFG.n0, num_outer=outer, **kw)


def make_algorithm(name: str, p, outer: int):
    steps = sum(algorithm.dpsvrg_algorithm(
        p, _dpsvrg_hp(outer)).meta.outer_lengths)
    if name == "dpsvrg":
        return algorithm.dpsvrg_algorithm(p, _dpsvrg_hp(outer)), 0
    if name == "dpsvrg_single":
        return algorithm.dpsvrg_algorithm(
            p, _dpsvrg_hp(outer, single_consensus=True)), 0
    if name == "dspg":
        return algorithm.dspg_algorithm(
            p, algorithm.DSPGHyperParams(alpha0=CFG.alpha), steps), 50
    return algorithm.loopless_dpsvrg_algorithm(
        p, CFG.alpha, COMPRESSED_STEPS), 4


def _gossip(g):
    if isinstance(g, tuple):
        return transport.CompressedBackend(inner=g[0], bits=g[1])
    return g


def fig1_build(ds, device):
    """Fig. 1's DPSVRG cells on the dataset (``pt_fig1_convergence``'s
    hyper-parameters), without its F(x*)."""
    p = problem(ds, 8, device)
    hp = algorithm.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4, num_outer=10)

    def build():
        return algorithm.dpsvrg_algorithm(p, hp), p

    return build


def _counts() -> dict:
    return {c: getattr(ops, c) for c in COUNTERS}


def _zero_counts() -> None:
    for c in COUNTERS:
        setattr(ops, c, 0)


def _summary(res, secs: float, launches: dict) -> dict:
    return {"history": res.history._asdict(), "params": res.params,
            "wire_bytes": np.asarray(res.extras["wire_bytes"]),
            "ledger": [int(res.extras["transfers_h2d"]),
                       int(res.extras["transfers_d2h"])],
            "wire": res.extras.get("wire"),
            "graphs_built": int(res.extras.get("graphs_built", 0)),
            "seconds": secs, "launches": launches}


def _timed(fn, device):
    _zero_counts()
    common.sync(device)
    t0 = time.perf_counter()
    out = fn()
    common.sync(device)
    return out, time.perf_counter() - t0, _counts()


def _kernels_vs_plain(rows: int, d: int, device) -> dict:
    """svrg_step and mix_prox on random operands of the rank's rows against
    their plain versions: the max abs errors."""
    gen = torch.Generator().manual_seed(spmd.dist.get_rank())
    x, gn, gs, mu, up, down = (torch.randn(rows, d, generator=gen).to(device)
                               for _ in range(6))
    q = ops.svrg_step(x, gn, gs, mu, CFG.alpha)
    q_ref = ref.svrg_step_ref(x, gn, gs, mu, CFG.alpha)
    z = ops.mix_prox(q, up, down, 1 / 3, 1 / 3, 1 / 3, CFG.alpha * CFG.lam)
    z_ref = ref.mix_prox_ref(q, up, down, 1 / 3, 1 / 3, 1 / 3,
                             CFG.alpha * CFG.lam)
    return {"svrg_step": float((q - q_ref).abs().max()),
            "mix_prox": float((z - z_ref).abs().max())}


def _traced_dspg(ds, device, parts) -> dict:
    """TRACE_STEPS DSPG steps over ppermute (one node a rank), then, over
    NCCL, the same steps under torch.profiler, read by
    ``launch.roofline.collective_bytes``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import roofline
    world = spmd.dist.get_world_size()
    rows = spmd.node_axis(spmd.world_mesh("nodes"), "nodes", world).rows
    p = problem(ds, world, device, rows, parts)
    ring = graphs.b_connected_ring_schedule(world, b=1, seed=0)
    algo = algorithm.dspg_algorithm(
        p, algorithm.DSPGHyperParams(alpha0=CFG.alpha), TRACE_STEPS)
    spec = ExecSpec(resident=True, gossip="ppermute", device=device)
    runner.run(algo, p, ring, spec, record_every=TRACE_STEPS)   # warm-up
    if spmd.dist.get_backend() != "nccl":
        return {"traced": False, "steps": TRACE_STEPS,
                "param_comms_sample": []}
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        res = runner.run(algo, p, ring, spec, record_every=TRACE_STEPS)
        common.sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        coll = roofline.collective_bytes(path, group_size=world)
        import json
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    aux = transport.GOSSIP_BACKENDS["ppermute"].prepare(ring, algo.meta)
    per_step = transport.GOSSIP_BACKENDS["ppermute"].bytes_per_step(
        aux, transport.GOSSIP_BACKENDS["ppermute"].phi_for(aux, 1, 1),
        ds.dim)
    return {"traced": True, "collective_bytes": coll, "steps": TRACE_STEPS,
            "bytes_per_step": int(per_step),
            "wire_bytes": int(res.extras["wire_bytes"][-1]),
            "param_comms_events": len(comms),
            "param_comms_with_sizes": sum(
                1 for e in comms if "Out msg nelems" in e.get("args", {})),
            "param_comms_names": sorted({str(e.get("args", {}).get(
                "Collective name")) for e in comms}),
            "param_comms_sample": comms[:6]}


def rank_runs(scale: float, outer: int, device: str, t_spawn: float) -> dict:
    """Every run of the phase on this rank (``spmd.spawn`` starts the
    ranks; each makes the same calls).  The traced DSPG steps go first:
    with their own untimed run before them they warm the wire, the
    allocator and the libraries up for the timed runs.  ``stage_s``: the
    wall clock since ``t_spawn`` (the parent's ``time.time()`` at the
    spawn) at each stage."""
    stage = {"entered": time.time() - t_spawn}
    ds = dataset(scale)
    parts = {m: synthetic.partition_per_node(ds, m) for m in (4, 8)}
    stage["data"] = time.time() - t_spawn
    out = {"trace": _traced_dspg(ds, device, parts[RANKS]), "stage_s": stage}
    stage["trace"] = time.time() - t_spawn
    for name, (m, gossip, algo, kernel, _) in RUNS.items():
        mesh = spmd.world_mesh("nodes")
        rows = spmd.node_axis(mesh, "nodes", m).rows
        p = problem(ds, m, device, rows, parts[m])
        a, every = make_algorithm(algo, p, outer)
        spec = ExecSpec(resident=True, gossip=_gossip(gossip),
                        shard="nodes", kernel=kernel, device=device)
        ring = graphs.b_connected_ring_schedule(m, b=1, seed=0)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res, secs, launches = _timed(lambda: runner.run(
            a, p, ring, spec, seed=0, record_every=every), device)
        out[name] = _summary(res, secs, launches)
        out[name]["rows"] = rows.stop - rows.start
        if torch.device(device).type == "cuda":
            out[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        stage[name] = time.time() - t_spawn
    build = fig1_build(ds, device)
    cells = ExecSpec(resident=True, gossip="dense", shard="cells",
                     kernel="fused", device=device)
    sched = graphs.b_connected_ring_schedule(8, b=1)
    res, secs, launches = _timed(lambda: sweep.run_sweep(
        build, {"seed": list(range(FIG1_SEEDS))}, sched, cells,
        record_every=4), device)
    out["cells_fig1"] = _summary(res, secs, launches)
    out["kernels_vs_plain"] = _kernels_vs_plain(2, ds.dim, device)
    stage["done"] = time.time() - t_spawn
    return out


def twin(ds, name: str, outer: int, device):
    """Run ``name`` on the whole stack in this process, twice; -> (result,
    the second run's seconds)."""
    m, _, algo, _, gossip = RUNS[name]
    p = problem(ds, m, device)
    a, every = make_algorithm(algo, p, outer)
    spec = ExecSpec(resident=True, gossip=_gossip(gossip), kernel="plain",
                    device=device)
    ring = graphs.b_connected_ring_schedule(m, b=1, seed=0)
    for _ in range(2):
        res, secs, _ = _timed(lambda: runner.run(a, p, ring, spec, seed=0,
                                                 record_every=every), device)
    return res, secs


def _max_diff(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _params(p) -> np.ndarray:
    return p.detach().cpu().numpy() if isinstance(p, torch.Tensor) \
        else np.asarray(p)


def run(device="cuda", scale: float = 1.0, outer: int = OUTER,
        ranks: list | None = None) -> dict:
    """Spawn the ranks, run the twins, hold one to the other; returns the
    phase's summary (raises on a mismatch).  ``ranks``: each rank's
    ``rank_runs`` result from a group spawned elsewhere (phase 31's, which
    runs these runs first), in place of a spawn here."""
    device = common.require_device(device)
    kind = device.type
    backend = spmd.backend_for(device, RANKS)
    spawn_s = None
    if ranks is None:
        t0 = time.perf_counter()
        ranks = spmd.spawn(rank_runs, RANKS, backend=backend, device=kind,
                           args=(scale, outer, kind, time.time()),
                           timeout=TIMEOUT)
        spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    for other in ranks[1:]:
        for name in list(RUNS) + ["cells_fig1"]:
            np.testing.assert_array_equal(
                other[name]["history"]["objective"],
                r0[name]["history"]["objective"], err_msg=name)
    ds = dataset(scale)
    summary = {"ranks": RANKS, "backend": backend, "spawn_s": spawn_s,
               "rank0_stage_s": r0["stage_s"], "runs": {}}
    for name in RUNS:
        got = r0[name]
        res, secs = twin(ds, name, outer, str(device))
        steps = int(res.history.steps[-1])
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(got["history"][col],
                                       getattr(res.history, col),
                                       **HIST_TOL, err_msg=f"{name} {col}")
        np.testing.assert_allclose(got["params"], _params(res.params),
                                   **HIST_TOL, err_msg=f"{name} params")
        np.testing.assert_array_equal(got["wire_bytes"],
                                      res.extras["wire_bytes"],
                                      err_msg=f"{name} wire bytes")
        assert got["ledger"] == [1, 1], (name, got["ledger"])
        assert got["graphs_built"] == 0, name
        summary["runs"][name] = {
            "m": RUNS[name][0], "rows_per_rank": got["rows"],
            "gossip": str(RUNS[name][1]), "steps": steps,
            "wire": got["wire"], "wire_bytes": int(got["wire_bytes"][-1]),
            "sharded_ms_per_step": got["seconds"] / steps * 1e3,
            "unsharded_ms_per_step": secs / steps * 1e3,
            "max_abs_objective_vs_unsharded": _max_diff(
                got["history"]["objective"], res.history.objective),
            "max_abs_params_vs_unsharded": _max_diff(
                got["params"], _params(res.params)),
            "launches": got["launches"],
            "peak_bytes_per_rank": max(r[name].get("peak_bytes", 0)
                                       for r in ranks)}
    build = fig1_build(ds, str(device))
    base = ExecSpec(resident=True, gossip="dense", kernel="fused",
                    device=str(device))
    sched = graphs.b_connected_ring_schedule(8, b=1)
    for _ in range(2):              # the second run is timed, as twin's
        plain, secs, _ = _timed(lambda: sweep.run_sweep(
            build, {"seed": list(range(FIG1_SEEDS))}, sched, base,
            record_every=4), str(device))
    got = r0["cells_fig1"]
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(got["history"][col],
                                   getattr(plain.history, col), **HIST_TOL,
                                   err_msg=f"cells_fig1 {col}")
    np.testing.assert_array_equal(got["wire_bytes"],
                                  plain.extras["wire_bytes"])
    assert got["ledger"] == [1, 1], got["ledger"]
    steps = int(plain.history.steps[-1, 0])
    summary["runs"]["cells_fig1"] = {
        "cells": FIG1_SEEDS, "steps": steps, "wire": got["wire"],
        "sharded_ms_per_step": got["seconds"] / steps * 1e3,
        "unsharded_ms_per_step": secs / steps * 1e3,
        "max_abs_objective_vs_unsharded": _max_diff(
            got["history"]["objective"], plain.history.objective),
        "launches": got["launches"]}
    summary["kernels_vs_plain"] = max(
        (r["kernels_vs_plain"] for r in ranks),
        key=lambda k: max(k.values()))
    tr = r0["trace"]
    summary["trace"] = {k: v for k, v in tr.items()
                        if k != "param_comms_sample"}
    summary["trace_sample"] = tr["param_comms_sample"]
    return summary
