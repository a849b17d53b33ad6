#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. builds the fused resident-step CUDA kernel from the sources in this
   checkout (``nvcc``, sm_90a) and prints the build time and ptxas report;
3. holds the kernel against its plain PyTorch version on the card for both
   rules x three proxes at four shapes, and times kernel, plain version,
   ``torch.matmul(W, q)`` (``library_ms``: no single PyTorch call computes
   the fused function; the matrix product is its largest part) and the
   bound;
4. times the plain and the fused DPSVRG step, and the update alone (the
   only part in which the two steps differ), at d in {30, 1024, 8192,
   131072} (the measurements behind ``kernel="auto"``);
5. drives the main path at full width: DPSVRG then DSPG with the same step
   count on ``cifar10_like`` at scale 1.0 (n = 50,000, d = 1,024), m = 8,
   a b=1 ring, the paper's hyper-parameters, through
   ``ExecSpec(resident=True, kernel="fused", gossip="dense")``.  The kernel's
   launch count is set to 0 before and read after: it must equal the inner
   steps run.  Histories must be finite, the objective must fall, and both
   runs must match the same runs of the port on the CPU;
6. traces a shorter main-path run (DPSVRG, 10 outer rounds) with
   ``torch.profiler``: the card's busy time, idle share and kernels per
   step;
7. prints the card, a ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

Needs one card; exits non-zero without one, and without the repository
around it.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import paper_logreg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (algorithm, gossip, graphs, prox,  # noqa: E402
                              runner)
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_update import kernel, ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
KERNEL_SHAPES = [(8, 1024), (8, 1000), (8, 131072), (32, 4096)]
AUTO_DIMS = [30, 1024, 8192, 131072]
# kernel vs plain version on the card: both float32, but the kernel sums
# the m mix terms with FMAs in k order and cuBLAS in its own order, so they
# differ by float32 rounding of O(1) terms, growing with m
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
# port on the card vs port on the CPU, whole runs: the same float32
# arithmetic summed in different orders (the kernel and cuBLAS vs ATen's CPU
# kernels), compounded over the run — the tolerance of the CPU parity tests
HISTORY_RTOL = 1e-4
HISTORY_ATOL = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, samples: int = 7) -> float:
    """Median per-call time in ms: CUDA events around ``iters`` calls, over
    ``samples`` samples, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int = 20) -> float:
    """Median device time per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, the graph's replays timed by ``time_ms``.  The host's
    Python and launch overhead is out of the graph, so this is the card's
    time for the work, gaps between the captured kernels included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5) / iters


def logreg_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))  # Eq. 26


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_case(m: int, d: int, rule: str, seed: int, device):
    rng = np.random.default_rng(seed)
    n_streams = 4 if rule == "svrg" else 2
    streams = [torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                               device=device) for _ in range(n_streams)]
    # a doubly-stochastic mixing matrix: 3 rounds of a random b=2 ring
    w = graphs.b_connected_ring_schedule(m, 2, seed=seed).consensus_rounds(
        0, 3)
    return torch.as_tensor(w, dtype=torch.float32, device=device), streams


def fused_bound(m: int, d: int, rule: str, prox_kind: str):
    """(bound ms, what bounds it): each input read once, the output written
    once; flops of the elementwise direction, the step, the mix and the
    prox."""
    n_streams = 4 if rule == "svrg" else 2
    nbytes = (n_streams + 1) * m * d * 4 + m * m * 4
    flops = m * d * ((2 if rule == "svrg" else 0) + 2) + 2 * m * m * d \
        + m * d * {"l1": 4, "sql2": 1, "none": 0}[prox_kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(device) -> dict:
    alpha, lam = 0.05, 0.01
    rows = {}
    for m, d in KERNEL_SHAPES:
        for rule in ref.FUSED_RULES:
            for prox_kind in ref.FUSED_PROXES:
                w, streams = kernel_case(m, d, rule, seed=m * d, device=device)
                out = ops.fused_step_buf(w, streams, alpha, lam, rule=rule,
                                         prox_kind=prox_kind)
                plain = ref.fused_step_math(w, streams, alpha, lam, rule=rule,
                                            prox_kind=prox_kind)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, plain, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
                err = float((out - plain).abs().max())
                # the same alpha from device memory (the resident path's way)
                alpha_dev = torch.tensor([alpha], dtype=torch.float32,
                                         device=device)
                out_dev = ops.fused_step_buf(w, streams, alpha_dev[0], lam,
                                             rule=rule, prox_kind=prox_kind)
                if not torch.equal(out_dev, out):
                    fail(f"alpha from device memory differs: {rule} "
                         f"{prox_kind} {(m, d)}")
                q = streams[0] - alpha * streams[1]
                bound, bound_by = fused_bound(m, d, rule, prox_kind)
                # called as the resident path calls them: alpha on the card
                a = alpha_dev[0]

                def kern():
                    return ops.fused_step_buf(w, streams, a, lam, rule=rule,
                                              prox_kind=prox_kind)

                def plain_fn():
                    return ref.fused_step_math(w, streams, a, lam, rule=rule,
                                               prox_kind=prox_kind)

                # ms / plain_ms / library_ms: the card's time (CUDA graphs);
                # call_ms / plain_call_ms: eager calls, host overhead in
                row = {
                    "shape": [m, d], "rule": rule, "prox": prox_kind,
                    "max_abs_err": err,
                    "ms": graph_ms(kern), "plain_ms": graph_ms(plain_fn),
                    "library_ms": graph_ms(lambda: torch.matmul(w, q)),
                    "bound_ms": bound, "bound_by": bound_by,
                    "call_ms": time_ms(kern), "plain_call_ms": time_ms(plain_fn),
                    "launches": ops.launches,
                }
                rows[(m, d, rule, prox_kind)] = row
                print("kernel_case " + json.dumps(row), flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: plain vs fused DPSVRG step, for kernel="auto"
# ---------------------------------------------------------------------------

def time_auto(device) -> None:
    m, n_local = 8, 64
    for d in AUTO_DIMS:
        rng = np.random.default_rng(d)
        feats = rng.normal(size=(m, n_local, d)).astype(np.float32)
        feats *= 3.0 / np.linalg.norm(feats, axis=2, keepdims=True)
        data = params_from_numpy(
            {"features": feats,
             "labels": (rng.random((m, n_local)) < 0.5).astype(np.float32)},
            device)
        x0 = params_from_numpy(
            0.01 * rng.normal(size=(m, d)).astype(np.float32), device)
        problem = algorithm.Problem(logreg_loss, prox.l1(0.01), x0, data)
        algo = algorithm.dpsvrg_algorithm(
            problem, algorithm.DPSVRGHyperParams())
        state = algo.outer(algo.init())
        batch = {k: v[:, :1].contiguous() for k, v in data.items()}
        phi = torch.as_tensor(graphs.ring_matrix(m), dtype=torch.float32,
                              device=device)
        alpha = torch.tensor([0.01], dtype=torch.float32, device=device)[0]
        steps = {"plain": algo.step, "fused": algo.meta.fused_step("fused")}
        a = steps["plain"](state, batch, phi, alpha).params
        b = steps["fused"](state, batch, phi, alpha).params
        torch.testing.assert_close(b, a, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        # the two steps differ only in the update after the gradients:
        # time it alone too, on the step's own gradients
        grad = algorithm.build_node_grad_fn(logreg_loss)
        g_now = grad(state.params, batch)
        g_snap = grad(state.est.snapshot, batch)
        mu = state.est.full_grad
        updates = {
            "plain": lambda: algorithm.prox_gossip_update(
                state.params, g_now - g_snap + mu, phi, alpha, problem.prox),
            "fused": lambda: ops.fused_resident_step(
                phi, state.params, (g_now, g_snap, mu), alpha, 0.01,
                rule="svrg", prox_kind="l1")}
        # eager, as the resident runner calls them; timed in turns (plain,
        # fused, fused, plain) and averaged per kind
        times = {f"{kind}_{what}_ms": [] for kind in steps
                 for what in ("step", "update")}
        for kind in ("plain", "fused", "fused", "plain"):
            fn = steps[kind]
            times[f"{kind}_step_ms"].append(
                time_ms(lambda: fn(state, batch, phi, alpha)))
            times[f"{kind}_update_ms"].append(time_ms(updates[kind]))
        row = {"d": d, "m": m}
        row.update({k: statistics.mean(v) for k, v in times.items()})
        row["each"] = times
        # kernel="auto" decides on the update: the gradients are the same
        row["fused_wins"] = row["fused_update_ms"] < row["plain_update_ms"]
        print("auto_step " + json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def main_path_runs(device, parts, dim, kernel_mode):
    """DPSVRG then DSPG with the same step count, resident, on ``device``.
    Returns [(name, result, steps, launches, seconds)]."""
    cfg = paper_logreg.CONFIG
    m = cfg.num_nodes
    data = params_from_numpy(parts, device)
    x0 = gossip.stack_tree(torch.zeros(dim, device=device), m).contiguous()
    problem = algorithm.Problem(logreg_loss, prox.l1(cfg.lam), x0, data)
    sched = graphs.b_connected_ring_schedule(m, 1)
    spec = ExecSpec(resident=True, kernel=kernel_mode, gossip="dense",
                    device=device)
    dp = algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=cfg.alpha, beta=cfg.beta, n0=cfg.n0, num_outer=30))
    steps = sum(dp.meta.outer_lengths)
    ds = algorithm.dspg_algorithm(
        problem, algorithm.DSPGHyperParams(alpha0=cfg.alpha), steps)
    out = []
    for name, algo, every in (("dpsvrg", dp, 0), ("dspg", ds, 50)):
        before = ops.launches
        t0 = time.perf_counter()
        res = runner.run(algo, problem, sched, spec, seed=0,
                         record_every=every)
        if device != "cpu":
            torch.cuda.synchronize()
        out.append((name, res, steps, ops.launches - before,
                    time.perf_counter() - t0))
    return out


def check_history(name, res) -> None:
    h = res.history
    for col in ("objective", "consensus"):
        if not np.all(np.isfinite(getattr(h, col))):
            fail(f"{name}: non-finite {col}")
    if not torch.isfinite(res.params).all():
        fail(f"{name}: non-finite parameters")
    if not h.objective[-1] < h.objective[0]:
        fail(f"{name}: the objective did not fall "
             f"({h.objective[0]} -> {h.objective[-1]})")


def profile_main_path(parts, dim: int) -> dict:
    """Where the card's time goes on the main path: a resident DPSVRG run at
    full width (10 outer rounds) traced by ``torch.profiler`` after a warm
    run.  The device's busy time is the union of its kernels' intervals;
    the idle share is the rest of the traced run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = paper_logreg.CONFIG
    m = cfg.num_nodes
    data = params_from_numpy(parts, "cuda")
    x0 = gossip.stack_tree(torch.zeros(dim, device="cuda"), m).contiguous()
    problem = algorithm.Problem(logreg_loss, prox.l1(cfg.lam), x0, data)
    algo = algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=cfg.alpha, beta=cfg.beta, n0=cfg.n0, num_outer=10))
    sched = graphs.b_connected_ring_schedule(m, 1)
    spec = ExecSpec(resident=True, kernel="fused", gossip="dense")
    runner.run(algo, problem, sched, spec, record_every=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(algo, problem, sched, spec, record_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    steps = sum(algo.meta.outer_lengths)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms": wall_us / 1e3,
            "device_kernels": len(spans),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall_us) if spans else None,
            "kernels_per_step": len(spans) / steps,
            "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top}}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    logs = _build.build([kernel.SOURCE])
    build_s = time.perf_counter() - t0
    for log in logs.values():
        print(log.strip(), flush=True)
    print(f"build: {kernel.SOURCE.name} in {build_s:.1f} s "
          f"(max m {kernel.max_m()})", flush=True)

    # phase 3: kernel vs plain version
    rows = check_kernel(device)
    max_err = max(r["max_abs_err"] for r in rows.values())
    print(f"kernel: all {len(rows)} cases within rtol {KERNEL_RTOL} / atol "
          f"{KERNEL_ATOL} of the plain version (max abs err {max_err:.3g})",
          flush=True)

    # phase 4: the auto threshold's measurements
    time_auto(device)

    # phase 5: the main path at full width
    cfg = paper_logreg.CONFIG
    t0 = time.perf_counter()
    ds = synthetic.make_paper_dataset("cifar10_like", scale=1.0, seed=0)
    parts = synthetic.partition_per_node(ds, cfg.num_nodes)
    print(f"data: cifar10_like n={ds.n} d={ds.dim} m={cfg.num_nodes} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ops.launches = 0
    gpu = main_path_runs(device, parts, ds.dim, "fused")
    main_launches = ops.launches
    cpu = main_path_runs("cpu", parts, ds.dim, "fused")
    for (name, res, steps, launches, secs), (_, cres, _, _, csecs) in zip(
            gpu, cpu):
        if launches != steps:
            fail(f"{name}: {launches} kernel launches for {steps} steps")
        check_history(name, res)
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(cres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name} {col}: card vs CPU")
        np.testing.assert_array_equal(res.history.steps, cres.history.steps)
        print("main_path " + json.dumps({
            "algorithm": name, "steps": steps, "launches": launches,
            "records": len(res.history.objective),
            "objective_first": float(res.history.objective[0]),
            "objective_last": float(res.history.objective[-1]),
            "consensus_last": float(res.history.consensus[-1]),
            "max_abs_objective_vs_cpu": float(np.max(np.abs(
                res.history.objective - cres.history.objective))),
            "run_s": secs, "ms_per_step": secs / steps * 1e3,
            "cpu_run_s": csecs,
            "transfers_h2d": res.extras["transfers_h2d"],
            "transfers_d2h": res.extras["transfers_d2h"]}), flush=True)

    # phase 6: where the card's time goes on the main path
    print("profile " + json.dumps(profile_main_path(parts, ds.dim)),
          flush=True)

    main_row = rows[(8, 1024, "svrg", "l1")]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_step", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_update/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/fused_update/kernel.py:108",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
