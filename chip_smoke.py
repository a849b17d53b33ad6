#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. builds the three CUDA kernels of the port from the sources in this
   checkout (``nvcc``, sm_90a, one process each, all started together) and
   prints the build time and each ptxas report;
3. holds the fused resident-step kernel against its plain PyTorch version
   on the card for both rules x three proxes at four shapes, and times
   kernel, plain version, ``torch.matmul(W, q)`` (``library_ms``: no single
   PyTorch call computes the fused function; the matrix product is its
   largest part) and the bound;
4. times the plain and the fused DPSVRG step, and the update alone, at d
   in {30, 1024, 8192, 131072} (the measurements behind ``kernel="auto"``);
5. drives the logistic-regression path at full width: DPSVRG then DSPG
   with the same step count on ``cifar10_like`` at scale 1.0 (n = 50,000,
   d = 1,024), m = 8, a b=1 ring, the paper's hyper-parameters, through
   ``ExecSpec(resident=True, kernel="fused", gossip="dense")``.  The fused
   kernel's launch count is set to 0 before and read after: it must equal
   the inner steps run.  Histories must be finite, the objective must
   fall, and both runs must match the same runs of the port on the CPU;
6. traces a shorter logistic-regression run (DPSVRG, 10 outer rounds) with
   ``torch.profiler``: the card's busy time, idle share, kernels per step;
7. holds the RMSNorm and flash attention kernels against their plain
   versions on the card (RMSNorm: rows in {1, 3, 4, 8, 6144}, d in {128,
   2560}; flash: causal, window, softcap, GQA, bidirectional and ragged
   shapes, head_dim in {32, 80, 128, 256}, and the h2o-danube prefill at
   L = 6144; float32 and bf16), and times kernel, eager call, plain
   version, ``F.rms_norm`` / ``F.scaled_dot_product_attention``
   (``library_ms``, timed only) and the bound;
8. serves h2o-danube-1.8b at full width (24 layers, d_model 2560, f32,
   random weights from a seed, flash and RMSNorm kernels on) through
   ``ResidentEngine(max_slots=4, max_len=6208, chunk=8)``: 8 requests with
   prompts of 512 to 6144 tokens, 32 new tokens each.  The kernels' launch
   counts are set to 0 before and read after and must be exact; tokens
   must equal the host ``ContinuousBatcher``'s; the transfer ledger must
   be 8 uploads and one pull per chunk; each prefill's last logits and the
   teacher-forced decode logits must agree with the plain path
   (``use_flash=False, use_fused_norm=False``).  Prints ms per prefill,
   per chunk and per decode step, tokens/s, peak memory and the card's
   idle share over one traced prefill and one chunk;
9. replays a seeded Poisson stream through the same model (TTFT / TPOT);
10. runs ``repro_torch.launch.serve --arch h2o-danube-1.8b --stream`` at the
    launcher's smoke size;
11. prints the card, a ``{"kernels": [...]}`` line, and last
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
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import paper_logreg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (algorithm, gossip, graphs, prox,  # noqa: E402
                              runner)
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fused_update import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import metrics as serve_metrics  # noqa: E402
from repro_torch.serve import stream as serve_stream  # noqa: E402
from repro_torch.serve.engine import ResidentEngine  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# peak operation rates by operand type, dense (NVIDIA's H100 SXM data
# sheet): float32 outside the tensor cores, bf16 on the tensor cores.  A
# bf16 bound is taken at the tensor-core rate even for a kernel that does
# not use them, since the card could do the work at that rate.
FLOPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
    return bound(nbytes, flops)


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
    steps = sum(algo.meta.outer_lengths)
    out = {"steps": steps}
    out.update(device_busy(prof, wall_us))
    out["kernels_per_step"] = out["device_kernels"] / steps
    return out


def device_busy(prof, wall_us: float) -> dict:
    """The card's busy time in a traced window: the union of its kernels'
    intervals; the idle share is the rest of the window's wall time."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_kernels": len(spans),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall_us) if spans else None,
            "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top}}


# ---------------------------------------------------------------------------
# phase 7: RMSNorm and flash attention against their plain versions
# ---------------------------------------------------------------------------

# Kernel on the card vs plain version on the card.  float32: the same
# formula summed in other orders (a block reduction of x^2 in RMSNorm; FMA
# dot products and an online softmax in flash, cuBLAS and a full softmax in
# the plain version); 2e-5 is the reference's own tolerance for its flash
# kernel (tests/test_kernels.py).  bf16 RMSNorm: both round a float32
# value to bf16 and may land on neighbouring values, one bf16 ulp apart,
# at most 2^-7 = 7.8e-3 of the value.  bf16 flash: held against the plain
# version on the float32 values of the same bf16 inputs; the kernel works
# in float32 and rounds only its output to bf16, at most 2^-8 = 3.9e-3 of
# the value, on top of the float32 tolerance.
RMS_F32_TOL = dict(rtol=1e-5, atol=1e-5)
RMS_BF16_TOL = dict(rtol=8e-3, atol=1e-5)
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-5)
FLASH_BF16_TOL = dict(rtol=4e-3, atol=2e-5)
RMS_ROWS = [1, 3, 4, 8, 6144]
RMS_DIMS = [128, 2560]
# the shape of the kernels line: a decode step of the serving path (4 slots)
RMS_LINE_SHAPE = (4, 2560)
# b, h, kv, sq, sk, hd, causal, window, softcap
FLASH_CASES = [
    (1, 4, 2, 128, 128, 64, True, None, None),      # GQA 2x, causal
    (2, 4, 4, 256, 256, 32, True, None, None),      # MHA, batch 2
    (1, 8, 2, 128, 128, 64, True, 64, None),        # GQA 4x + window
    (1, 2, 1, 128, 256, 64, True, None, 50.0),      # softcap, sk > sq
    (1, 4, 2, 100, 100, 80, True, None, None),      # ragged q and k, hd 80
    (1, 4, 2, 77, 130, 80, False, None, None),      # bidirectional, ragged
    (1, 4, 4, 200, 200, 128, False, 37, None),      # bidirectional + window
    (1, 4, 2, 300, 300, 256, True, 100, 50.0),      # gemma2's head_dim 256
    (1, 32, 8, 6144, 6144, 80, True, 4096, None),   # h2o-danube prefill
]
DANUBE_FLASH_CASE = FLASH_CASES[-1]


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """(bound ms, what bounds it): bytes at the memory rate or operations
    at the card's peak rate for their type, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_rmsnorm(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(7)
    rows_out = {}
    for d in RMS_DIMS:
        for n in RMS_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n, d, generator=gen, device=device).to(dtype)
                w = (0.1 * torch.randn(d, generator=gen, device=device)
                     ).to(dtype)
                out = rn_ops.rmsnorm(x, w)
                plain = rn_ref.rmsnorm_ref(x, w)
                torch.cuda.synchronize()
                tol = RMS_F32_TOL if dtype == torch.float32 else RMS_BF16_TOL
                torch.testing.assert_close(out, plain, **tol)
                err = float((out.float() - plain.float()).abs().max())
                w1 = 1.0 + w
                es = x.element_size()
                bnd, bnd_by = bound((2 * n * d + d) * es, 4 * n * d, dtype)

                def kern():
                    return rn_ops.rmsnorm(x, w)

                def plain_fn():
                    return rn_ref.rmsnorm_ref(x, w)

                row = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err,
                       "ms": graph_ms(kern), "call_ms": time_ms(kern),
                       "plain_ms": graph_ms(plain_fn),
                       "library_ms": graph_ms(
                           lambda: F.rms_norm(x, (d,), w1, 1e-6)),
                       "bound_ms": bnd, "bound_by": bnd_by}
                rows_out[(n, d, row["dtype"])] = row
                print("rmsnorm_case " + json.dumps(row), flush=True)
    return rows_out


def check_flash(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(8)
    rows_out = {}
    for case in FLASH_CASES:
        b, h, kv, sq, sk, hd, causal, win, cap = case
        big = sq * sk * h > 1 << 28
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                                   device=device).to(dtype)
                       for s, n in ((sq, h), (sk, kv), (sk, kv)))
            kw = dict(causal=causal, sliding_window=win, softcap=cap)
            out = fa_ops.flash_attention(q, k, v, **kw)
            plain = fa_ref.attention_ref(
                q.float().transpose(1, 2), k.float().transpose(1, 2),
                v.float().transpose(1, 2), **kw).transpose(1, 2)
            torch.cuda.synchronize()
            tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
            torch.testing.assert_close(out.float(), plain, **tol)
            err = float((out.float() - plain).abs().max())
            del plain
            ok = fa_ref.mask(sq, sk, causal=causal, sliding_window=win,
                             device=device)
            pairs = int(ok.sum())
            es = q.element_size()
            bnd, bnd_by = bound((2 * b * sq * h + 2 * b * sk * kv) * hd * es,
                                4 * hd * pairs * h * b, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def kern():
                return fa_ops.flash_attention(q, k, v, **kw)

            def plain_fn():
                return fa_ref.attention_ref(qt, kt, vt, **kw)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=ok, enable_gqa=True)

            iters = 2 if big else 20
            row = {"case": list(case), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "pairs": pairs,
                   "ms": graph_ms(kern, iters),
                   "call_ms": time_ms(kern, iters=iters),
                   "plain_ms": graph_ms(plain_fn, iters),
                   # the library has no softcap: no call computes that case
                   "library_ms": None if cap is not None
                   else graph_ms(library, iters),
                   "bound_ms": bnd, "bound_by": bnd_by}
            rows_out[(case, row["dtype"])] = row
            print("flash_case " + json.dumps(row), flush=True)
            del q, k, v, qt, kt, vt, ok
            torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# phases 8-10: serving h2o-danube-1.8b at full width
# ---------------------------------------------------------------------------

DANUBE_SEED = 0
DANUBE_PROMPTS = [512, 1024, 2048, 3072, 4096, 4608, 5120, 6144]
DANUBE_NEW = 32
DANUBE_SLOTS, DANUBE_MAX_LEN, DANUBE_CHUNK = 4, 6208, 8
SERVE_DEVICE = "cuda"
STREAM_RATE = 2.0          # mean arrivals per second of the replayed stream
# Kernel path (flash + RMSNorm kernels) vs plain path, both on the card, on
# logits of order 1: the same float32 arithmetic summed in other orders
# (online softmax over 64-key tiles, a block reduction in RMSNorm),
# compounded through 24 layers of a 2560-wide residual stream and up to
# 6144 positions; the tolerance keeps three significant digits.
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


class TimedEngine(ResidentEngine):
    """ResidentEngine that times each admission (prefill and splice) and
    each decode chunk, with the card synchronised around each."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prefill_ms: dict[int, float] = {}
        self.chunk_ms: list[float] = []

    def _admit(self, slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._admit(slot, req)
        torch.cuda.synchronize()
        self.prefill_ms[len(req.tokens)] = (time.perf_counter() - t0) * 1e3

    def _run_chunk(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._run_chunk()
        torch.cuda.synchronize()
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)


def danube_requests(vocab: int) -> list:
    rng = np.random.default_rng(DANUBE_SEED)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=n)
                    .astype(np.int32), max_new_tokens=DANUBE_NEW)
            for i, n in enumerate(DANUBE_PROMPTS)]


def serve_danube() -> dict:
    """Phase 8.  Returns the numbers of the serving run."""
    cfg = configs.get_config("h2o-danube-1.8b").scaled(
        use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, DANUBE_SEED, device=SERVE_DEVICE)
    torch.cuda.synchronize()
    print(f"danube: {transformer.param_count(params)} parameters (f32) on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = danube_requests(cfg.vocab_size)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    eng = TimedEngine(cfg, params, max_slots=DANUBE_SLOTS,
                      max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK)
    for r in reqs:
        eng.submit(r)
    rn_ops.launches = 0
    fa_ops.launches = 0
    t0 = time.perf_counter()
    outs = eng.run_until_done()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    flash_n, rms_n = fa_ops.launches, rn_ops.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = eng.transfers["chunks"]
    steps = chunks * DANUBE_CHUNK
    want_flash = cfg.num_layers * len(reqs)
    want_rms = (2 * cfg.num_layers + 1) * (len(reqs) + steps)
    if flash_n != want_flash:
        fail(f"danube: {flash_n} flash launches, want {want_flash}")
    if rms_n != want_rms:
        fail(f"danube: {rms_n} rmsnorm launches, want {want_rms}")
    want_transfers = {"h2d": len(reqs), "d2h": chunks, "chunks": chunks}
    if eng.transfers != want_transfers:
        fail(f"danube: transfers {eng.transfers} != {want_transfers}")
    tokens = 0
    for r in reqs:
        if len(outs[r.uid]) != DANUBE_NEW:
            fail(f"danube: request {r.uid} gave {len(outs[r.uid])} tokens")
        tokens += len(outs[r.uid])
    result = {"launches": {"flash_attention": flash_n, "rmsnorm": rms_n},
              "transfers": dict(eng.transfers), "decode_steps": steps,
              "wall_s": wall_s, "tokens": tokens,
              "tokens_per_s": tokens / wall_s,
              "engine_prefill_ms": {str(k): v for k, v in
                                    sorted(eng.prefill_ms.items())},
              "chunk_ms": statistics.median(eng.chunk_ms),
              "chunk_ms_each": eng.chunk_ms,
              "decode_step_ms": statistics.median(eng.chunk_ms)
              / DANUBE_CHUNK,
              "max_memory_allocated_bytes": peak}
    del eng
    torch.cuda.empty_cache()

    # the host batcher on the same requests: the same tokens
    host = ContinuousBatcher(cfg, params, max_slots=DANUBE_SLOTS,
                             max_len=DANUBE_MAX_LEN)
    for r in reqs:
        host.submit(r)
    host_out = host.run_until_done()
    for r in reqs:
        if not np.array_equal(host_out[r.uid], outs[r.uid]):
            fail(f"danube: request {r.uid}: resident engine and host "
                 f"batcher tokens differ")
    del host
    torch.cuda.empty_cache()

    # kernel path vs plain path: each prefill's last logits, then the
    # decode logits with the engine's tokens fed back (teacher forcing)
    plain_cfg = cfg.scaled(use_flash=False, use_fused_norm=False)
    prefill_err = decode_err = 0.0
    greedy_agree = greedy_total = 0
    kernel_ms, plain_ms = {}, {}
    for r in reqs:
        toks = torch.as_tensor(r.tokens, device=SERVE_DEVICE)[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, ck = transformer.prefill(cfg, params, toks,
                                     max_len=DANUBE_MAX_LEN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lp, cp = transformer.prefill(plain_cfg, params, toks,
                                     max_len=DANUBE_MAX_LEN)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kernel_ms[len(r.tokens)] = (t1 - t0) * 1e3
        plain_ms[len(r.tokens)] = (t2 - t1) * 1e3
        torch.testing.assert_close(lk, lp, **LOGIT_TOL)
        prefill_err = max(prefill_err, float((lk - lp).abs().max()))
        out = outs[r.uid]
        greedy_agree += int(int(lk.argmax()) == int(out[0]))
        greedy_total += 1
        for t in range(len(out) - 1):
            tok = torch.tensor([int(out[t])], dtype=torch.int32,
                               device=SERVE_DEVICE)
            lk, ck = transformer.decode_step(cfg, params, ck, tok)
            lp, cp = transformer.decode_step(plain_cfg, params, cp, tok)
            torch.testing.assert_close(lk, lp, **LOGIT_TOL)
            decode_err = max(decode_err, float((lk - lp).abs().max()))
            greedy_agree += int(int(lk.argmax()) == int(out[t + 1]))
            greedy_total += 1
        del ck, cp
    torch.cuda.empty_cache()
    result.update({
        "prefill_ms": {str(k): v for k, v in sorted(kernel_ms.items())},
        "plain_prefill_ms": {str(k): v for k, v in sorted(plain_ms.items())},
        "max_abs_logit_err_prefill": prefill_err,
        "max_abs_logit_err_decode": decode_err,
        "greedy_batch1_agrees": f"{greedy_agree}/{greedy_total}"})

    # where the card's time goes: one prefill and one decode chunk, traced
    from torch.profiler import ProfilerActivity, profile
    eng = ResidentEngine(cfg, params, max_slots=DANUBE_SLOTS,
                         max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK)
    for r in reqs[:DANUBE_SLOTS]:
        eng.submit(Request(uid=r.uid, tokens=r.tokens[:512],
                           max_new_tokens=64))
    eng._admit_all()
    toks = torch.as_tensor(reqs[2].tokens, device=SERVE_DEVICE)[None]   # 2048
    transformer.prefill(cfg, params, toks, max_len=DANUBE_MAX_LEN)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer.prefill(cfg, params, toks, max_len=DANUBE_MAX_LEN)
        eng._run_chunk()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    result["profile_prefill2048_and_chunk"] = device_busy(prof, wall_us)
    del eng
    torch.cuda.empty_cache()
    print("danube_serve " + json.dumps(result), flush=True)

    # phase 9: a seeded Poisson stream through the same model
    sc = serve_stream.StreamConfig(
        num_requests=8, vocab_size=cfg.vocab_size, arrival="poisson",
        rate=STREAM_RATE, prompt_lens=(512, 2048, 6144), new_low=16,
        new_high=32, seed=DANUBE_SEED)
    stream_reqs = serve_stream.make_requests(sc)
    eng = ResidentEngine(cfg, params, max_slots=DANUBE_SLOTS,
                         max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK)
    summary = serve_metrics.summarize(serve_stream.replay(eng, stream_reqs))
    want = sum(r.max_new_tokens for r in stream_reqs)
    if summary["requests"] != len(stream_reqs) or summary["tokens"] != want:
        fail(f"danube stream: {summary['requests']} requests, "
             f"{summary['tokens']} tokens, want {len(stream_reqs)}, {want}")
    print("danube_stream " + json.dumps(dict(summary, rate=STREAM_RATE)),
          flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return result


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

    # phase 2: build every kernel, one nvcc each, all started together
    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for source, log in logs.items():
        print(f"--- ptxas: {source.name}", flush=True)
        print(log.strip(), flush=True)
    print(f"build: {', '.join(s.name for s in SOURCES)} in {build_s:.1f} s "
          f"(fused_step max m {kernel.max_m()})", flush=True)

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

    # phase 7: RMSNorm and flash attention against their plain versions
    rms_rows = check_rmsnorm(device)
    flash_rows = check_flash(device)
    rms_err = max(r["max_abs_err"] for r in rms_rows.values()
                  if r["dtype"] == "float32")
    flash_err = max(r["max_abs_err"] for r in flash_rows.values()
                    if r["dtype"] == "float32")
    print(f"rmsnorm: all {len(rms_rows)} cases within tolerance of the "
          f"plain version (float32 max abs err {rms_err:.3g}); flash: all "
          f"{len(flash_rows)} cases (float32 max abs err {flash_err:.3g})",
          flush=True)

    # phases 8-9: serve h2o-danube-1.8b at full width, then a stream
    serve = serve_danube()

    # phase 10: the launcher at its smoke size
    summary = launch_serve.main(["--arch", "h2o-danube-1.8b", "--stream"])
    if summary["requests"] != 16:
        fail(f"launch.serve: {summary['requests']} requests finished")

    main_row = rows[(8, 1024, "svrg", "l1")]
    rms_row = rms_rows[RMS_LINE_SHAPE + ("float32",)]
    flash_row = flash_rows[(DANUBE_FLASH_CASE, "float32")]

    def line(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        line("fused_step",
             "src/repro_torch/kernels/fused_update/csrc/fused_step.cu",
             "src/repro/kernels/fused_update/kernel.py:108", main_launches,
             max_err, main_row),
        line("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:37",
             serve["launches"]["rmsnorm"], rms_err, rms_row),
        line("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:106",
             serve["launches"]["flash_attention"], flash_err, flash_row),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
