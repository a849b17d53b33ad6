#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. builds the six CUDA kernels of the port (four sources; flash
   attention is two kernels, float32 and bf16, behind one entry point)
   from this checkout (``nvcc``, sm_90a, one process each, all started
   together), prints the build time and each ptxas report, and a
   ``flash_sass`` line: the number of ``HGMMA`` (wgmma) instructions in the
   built flash library, from ``cuobjdump -sass``;
3. holds the fused resident-step kernel against its plain PyTorch version
   on the card for both rules x three proxes at four shapes, and times
   kernel, plain version, ``torch.matmul(W, q)`` (``library_ms``: no single
   PyTorch call computes the fused function; the matrix product is its
   largest part), the bound and the launch floor (``floor_ms``: an empty
   kernel of ``fused_step.cu``, timed the same way);
4. holds ``svrg_step`` and ``mix_prox`` against their plain versions on the
   card (lengths 1, 7, 1000, 8 x 1024 and 2048 x 1024, and views at an odd
   offset; alpha in {0, 0.05, 1} by value and from device memory; the
   reference's mix cases): max abs err 0.  Times kernel, eager call, plain
   version and bound at 2048 x 1024 and 16384 x 1024, with the unfused
   torch chain beside them (no one PyTorch call computes either function,
   so ``library_ms`` is null);
5. times the plain and the fused DPSVRG step, and the update alone, at d
   in {30, 1024, 8192, 131072} (the measurements behind ``kernel="auto"``);
6. drives the logistic-regression path at full width: DPSVRG then DSPG
   with the same step count on ``cifar10_like`` at scale 1.0 (n = 50,000,
   d = 1,024), m = 8, a b=1 ring, the paper's hyper-parameters, through
   ``ExecSpec(resident=True, kernel="fused", gossip="dense")``, which on
   the card replays CUDA graphs of the chunks' pieces.  The fused
   kernel's launch count is set to 0 before and read after: it must equal
   the inner steps run.  Each run must build at most ceil(log2(longest
   chunk)) + 1 graphs and report the transfer ledger (1, 1).  Histories
   must be finite, the objective must fall, and both runs must match the
   same runs of the port on the CPU and the same runs through the eager
   executor on the card (``max_abs_graph_vs_eager``);
7. traces a shorter logistic-regression run (DPSVRG, 10 outer rounds) with
   ``torch.profiler``: the card's busy time, idle share, kernels per step;
8. runs the kernel bench at full width (``benchmarks/pt_kernel_bench``):
   ``run(scale=1.0)`` with every launch count set to 0 before and read
   after (svrg_step and mix_prox must equal the calls the bench made; the
   banded d = 131,072 loopless DPSVRG fused run must launch fused_step
   once per inner step), its histories held to the same bench run on the
   CPU, the bench's moving-iterate twin of that row (l1 at 1e-4) among
   them; then a DVR fused run on the same banded stack (launches equal to
   steps), the same DVR at l1 1e-4, where the iterate moves (its nonzero
   count printed, held to its CPU run and to the plain step on the card),
   and DSPG on the paper's b=1 ring through ``gossip="auto"``, which must
   pick ``banded``, all held to their CPU runs.  Every resident run of
   phases 6-8 must replay CUDA graphs;
9. holds the RMSNorm and flash attention kernels against their plain
   versions on the card (RMSNorm: rows in {1, 3, 4, 8, 6144}, d in {1, 7,
   128, 2304, 2560, 3584} and the first width past the register tiles;
   flash: causal, window, softcap, GQA, bidirectional and ragged shapes,
   head_dim in {32, 33, 80, 128, 256}, and the h2o-danube prefill at
   L = 6144; float32 within rtol 1e-5 / atol 2e-5, bf16 within the
   element-wise bound ``ref.bf16_bound``), and times kernel, eager call,
   plain version, ``F.rms_norm`` / ``F.scaled_dot_product_attention``
   (``library_ms``, timed only), a copy of RMSNorm's input (``copy_ms``,
   the memory rate's yardstick) and the bound, with ``share_of_bound``
   (bound / kernel time) on every row;
10. runs h2o-danube-1.8b at full width in bf16 (random weights from a
   seed, 3.5 GB) through a 2048-token and a 6144-token prefill on the
   kernel path (exactly 24 bf16 flash launches each; each prefill is timed
   after one untimed call at its length) and on the plain path, and holds both to the float32 kernel path on the same weights
   cast back to float32: the kernel path's max abs logit error must stay
   within 1.5x the plain path's;
11. serves h2o-danube-1.8b at full width (24 layers, d_model 2560, f32,
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
12. replays a seeded Poisson stream through the same model (TTFT / TPOT);
13. runs ``repro_torch.launch.serve --arch h2o-danube-1.8b --stream`` at the
    launcher's smoke size;
14. prints the card, a ``{"kernels": [...]}`` line (all six kernels, each
    with its ``share_of_bound``), and last ``{"ok": true, "device":
    {...}}``.

Needs one card; exits non-zero without one, and without the repository
around it.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import paper_logreg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (algorithm, gossip, graphs, prox,  # noqa: E402
                              runner, transport)
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fused_update import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import metrics as serve_metrics  # noqa: E402
from repro_torch.serve import stream as serve_stream  # noqa: E402
from repro_torch.serve.engine import ResidentEngine  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from benchmarks import pt_common, pt_kernel_bench  # noqa: E402

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


def noop_floor_ms() -> float:
    """The launch floor: an empty kernel of fused_step.cu (one block),
    timed as the kernel is (``graph_ms``)."""
    def noop():
        rc = kernel.noop_launch()
        if rc != 0:
            fail(f"the empty kernel did not launch (status {rc})")
    return graph_ms(noop)


def check_kernel(device) -> dict:
    alpha, lam = 0.05, 0.01
    rows = {}
    floor = noop_floor_ms()
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
                    "floor_ms": floor,
                    "call_ms": time_ms(kern), "plain_call_ms": time_ms(plain_fn),
                    "launches": ops.launches,
                }
                rows[(m, d, rule, prox_kind)] = row
                print("kernel_case " + json.dumps(row), flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: svrg_step and mix_prox against their plain versions
# ---------------------------------------------------------------------------

# lengths of the flat buffers: a single element, a ragged tail of 3 after a
# float4, a ragged tail after 250 float4s, one (8, 1024) TPU tile, and the
# kernel bench's 8 MiB per stream
SVRG_MIX_LENGTHS = [1, 7, 1000, 8 * 1024, 2048 * 1024]
# views one element into a buffer: not 16-byte aligned, so the scalar path
SVRG_MIX_MISALIGNED = [1000, 8 * 1024]
SVRG_ALPHAS = [0.0, 0.05, 1.0]
# (w_self, w_up, w_down, thresh): the reference's cases (tests/test_kernels)
MIX_CASES = [(1.0, 0.0, 0.0, 0.0), (1 / 3, 1 / 3, 1 / 3, 0.01),
             (0.5, 0.25, 0.25, 0.3)]
# rows of 1024 timed: the bench's shape (40 MiB for svrg_step, under the
# card's 50 MB L2, so repeated calls may be served from L2 and beat the
# memory bound) and 16384 rows (64 MiB per stream), well over the L2
SVRG_MIX_TIMED_ROWS = [2048, 16384]
SVRG_FLOPS, MIX_FLOPS = 4, 8       # per element (mix: 3 mul, 2 add, prox 3)


def _flat_operands(n: int, count: int, seed: int, device, offset: int = 0):
    """``count`` float32 buffers of n elements from a seed; with ``offset``
    each is a view that starts ``offset`` elements into a larger buffer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        base = torch.as_tensor(rng.normal(size=n + offset),
                               dtype=torch.float32, device=device)
        out.append(base[offset:])
    return out


def check_svrg_mix(device) -> tuple:
    """Every case must equal the plain version exactly.  Returns (the max
    abs err of each kernel over its cases, the timing rows by (kernel,
    rows))."""
    cases = 0
    max_err = {"svrg_step": 0.0, "mix_prox": 0.0}
    shapes = [(n, 0) for n in SVRG_MIX_LENGTHS] + \
        [(n, 1) for n in SVRG_MIX_MISALIGNED]
    for n, offset in shapes:
        x, gn, gs, mu = _flat_operands(n, 4, n + offset, device, offset)
        for alpha in SVRG_ALPHAS:
            alpha_dev = torch.tensor([alpha], dtype=torch.float32,
                                     device=device)[0]
            plain = ref.svrg_step_ref(x, gn, gs, mu, alpha)
            for a in (alpha, alpha_dev):
                out = ops.svrg_step(x, gn, gs, mu, a)
                err = float((out - plain).abs().max())
                if not torch.equal(out, plain):
                    fail(f"svrg_step differs from its plain version: n={n} "
                         f"offset={offset} alpha={alpha} "
                         f"({type(a).__name__}), max abs err {err}")
                max_err["svrg_step"] = max(max_err["svrg_step"], err)
                cases += 1
        for w_s, w_u, w_d, th in MIX_CASES:
            out = ops.mix_prox(x, gn, gs, w_s, w_u, w_d, th)
            plain = ref.mix_prox_ref(x, gn, gs, w_s, w_u, w_d, th)
            err = float((out - plain).abs().max())
            if not torch.equal(out, plain):
                fail(f"mix_prox differs from its plain version: n={n} "
                     f"offset={offset} case={(w_s, w_u, w_d, th)}, max abs "
                     f"err {err}")
            max_err["mix_prox"] = max(max_err["mix_prox"], err)
            cases += 1
    print(f"svrg_mix: all {cases} cases equal to the plain version (max abs "
          f"err 0)", flush=True)

    rows = {}
    alpha, (w_s, w_u, w_d, th) = 0.05, MIX_CASES[1]
    for n_rows in SVRG_MIX_TIMED_ROWS:
        x, gn, gs, mu = (t.reshape(n_rows, 1024) for t in _flat_operands(
            n_rows * 1024, 4, n_rows, device))
        n = x.numel()
        a = torch.tensor([alpha], dtype=torch.float32, device=device)[0]

        def unfused():
            q = x - a * (gn - gs + mu)
            return torch.sign(q) * torch.clamp_min(torch.abs(q) - th, 0.0)

        unfused_ms = graph_ms(unfused)
        for name, kern, plain_fn, streams, flops in (
                ("svrg_step", lambda: ops.svrg_step(x, gn, gs, mu, a),
                 lambda: ref.svrg_step_ref(x, gn, gs, mu, a), 5, SVRG_FLOPS),
                ("mix_prox", lambda: ops.mix_prox(x, gn, gs, w_s, w_u, w_d,
                                                  th),
                 lambda: ref.mix_prox_ref(x, gn, gs, w_s, w_u, w_d, th), 4,
                 MIX_FLOPS)):
            bnd, bnd_by = bound(streams * n * 4, flops * n)
            row = {"kernel": name, "shape": [n_rows, 1024],
                   "max_abs_err": float((kern() - plain_fn()).abs().max()),
                   "ms": graph_ms(kern), "call_ms": time_ms(kern),
                   "plain_ms": graph_ms(plain_fn), "library_ms": None,
                   "bound_ms": bnd, "bound_by": bnd_by,
                   "unfused_chain_ms": unfused_ms,
                   "l2_resident": streams * n * 4 < 50e6}
            row["share_of_bound"] = bnd / row["ms"]
            rows[(name, n_rows)] = row
            print("svrg_mix_case " + json.dumps(row), flush=True)
    return max_err, rows


# ---------------------------------------------------------------------------
# phase 5: plain vs fused DPSVRG step, for kernel="auto"
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
# phase 6: the main path at full width
# ---------------------------------------------------------------------------

def max_graphs(meta, record_every: int) -> int:
    """ceil(log2(longest chunk)) + 1: the most CUDA graphs a resident run
    of ``meta`` at ``record_every`` may build (a chunk never outruns a
    record interval, an inner round or the run)."""
    longest = (max(meta.outer_lengths) if meta.outer_lengths is not None
               else meta.num_steps)
    if record_every:
        longest = min(longest, record_every)
    return math.ceil(math.log2(longest)) + 1


def check_graphs(name: str, extras: dict, bound: int) -> None:
    """A resident run on the card replays CUDA graphs, at most ``bound``."""
    if extras["replays"] < 1:
        fail(f"{name}: the resident run replayed no CUDA graph")
    if not 1 <= extras["graphs_built"] <= bound:
        fail(f"{name}: {extras['graphs_built']} CUDA graphs built, at most "
             f"{bound} allowed")


def main_path_runs(device, parts, dim, kernel_mode):
    """DPSVRG then DSPG with the same step count, resident, on ``device``.
    Returns [(name, result, steps, launches, seconds, most graphs)]."""
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
                    time.perf_counter() - t0, max_graphs(algo.meta, every)))
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
        res = runner.run(algo, problem, sched, spec, record_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check_graphs("profile", res.extras, max_graphs(algo.meta, 0))
    steps = sum(algo.meta.outer_lengths)
    out = {"steps": steps, "graphs_built": res.extras["graphs_built"],
           "replays": res.extras["replays"],
           "capture_s": res.extras["capture_s"]}
    out.update(device_busy(prof, wall_us))
    out["kernels_per_step"] = out["device_kernels"] / steps
    return out


def device_busy(prof, wall_us: float) -> dict:
    """The card's busy time in a traced window: the union of its kernels'
    intervals; the idle share is the rest of the window's wall time."""
    # a record_function span (the runner's resident.* spans) also shows on
    # the device's timeline, as a user annotation of the same name: it is
    # not device work
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    annotations = {e.name for e in prof.events() if e.device_type == cpu
                   and getattr(e, "is_user_annotation", False)}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == cuda and e.name not in annotations
                   and not getattr(e, "is_user_annotation", False))
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
# phase 8: the kernel bench, DVR on the banded stack, DSPG through "auto"
# ---------------------------------------------------------------------------

BENCH_SCALE = 1.0      # the whole adult_like set for the paper-scale rows
DVR_STEPS = 40
DSPG_AUTO_STEPS = 600


def _reset_launches() -> None:
    ops.launches = ops.launches_svrg_step = ops.launches_mix_prox = 0
    rn_ops.launches = fa_ops.launches = 0


def _launch_counts() -> dict:
    return {"fused_step": ops.launches, "svrg_step": ops.launches_svrg_step,
            "mix_prox": ops.launches_mix_prox, "rmsnorm": rn_ops.launches,
            "flash_attention": fa_ops.launches}


def _held_to_cpu(name: str, card, cpu) -> float:
    """Assert a card history equals the CPU run's; returns the max abs
    difference of the objective."""
    card, cpu = np.asarray(card), np.asarray(cpu)
    np.testing.assert_allclose(card, cpu, rtol=HISTORY_RTOL,
                               atol=HISTORY_ATOL,
                               err_msg=f"{name}: card vs CPU")
    return float(np.max(np.abs(card - cpu)))


def kernel_bench_phase() -> dict:
    """Phase 8.  Returns the launch counts of the bench run and the rows."""
    t0 = time.perf_counter()
    _reset_launches()
    rows = pt_kernel_bench.run(scale=BENCH_SCALE, device="cuda")
    torch.cuda.synchronize()
    counts = _launch_counts()
    bench_s = time.perf_counter() - t0
    calls = {"svrg_step": 0, "mix_prox": 0}
    for r in rows:
        for k, v in r.data.get("calls", {}).items():
            calls[k] += v
    for k, want in calls.items():
        if counts[k] != want:
            fail(f"kernel bench: {counts[k]} {k} launches, the bench made "
                 f"{want} calls")
    if counts["fused_step"] == 0:
        fail("kernel bench: fused_step was never launched")
    by_name = {r.name: r for r in rows}
    errs = by_name["kernel/svrg_mix_check"].data["max_abs_err"]
    if any(v != 0.0 for v in errs.values()):
        fail(f"kernel bench: kernels differ from their plain versions "
             f"{errs}")
    ps = by_name["kernel/resident_paper_scale_auto"].data
    ld = by_name["kernel/resident_large_d_fused"].data
    mv = by_name["kernel/resident_large_d_moving"].data
    for sec, every in ((ps, 100), (ld, 20), (mv, 20)):
        if sec["fused_launches"] != sec["steps"]:
            fail(f"kernel bench {sec['algorithm']}: {sec['fused_launches']} "
                 f"fused_step launches for {sec['steps']} steps")
        check_graphs(f"kernel bench {sec['algorithm']}", sec,
                     math.ceil(math.log2(min(every, sec["steps"]))) + 1)
    if mv["nonzero"] == 0:
        fail("kernel bench: the moving large-d run never left 0")
    t1 = time.perf_counter()
    cpu = pt_kernel_bench.kernel_stats(BENCH_SCALE, "cpu", timed=False)
    cpu_s = time.perf_counter() - t1
    diffs = {}
    for key, sec in (("paper_scale", ps), ("large_d", ld),
                     ("large_d_moving", mv)):
        for kind, hist in sec["objective"].items():
            diffs[f"{key}/{kind}"] = _held_to_cpu(
                f"{key} {kind}", hist, cpu[key]["objective"][kind])
    summary = {
        "launches": counts, "calls": calls, "bench_s": bench_s,
        "cpu_reference_s": cpu_s, "max_abs_objective_vs_cpu": diffs,
        "rows": [{"name": r.name, "us_per_call": r.us_per_call,
                  "derived": r.derived} for r in rows],
        "paper_scale": {k: v for k, v in ps.items() if k != "objective"},
        "large_d": {k: v for k, v in ld.items() if k != "objective"},
        "large_d_moving": {k: v for k, v in mv.items() if k != "objective"},
    }
    print("kernel_bench " + json.dumps(summary), flush=True)
    return summary


def profile_large_d() -> dict:
    """Where the banded d = 131,072 fused run's time goes: one run of the
    bench's loopless DPSVRG traced by ``torch.profiler`` after a warm run.
    Besides the card's busy time, the runner's own spans split the host's
    wall time: the plan (minibatch indices, gossip products), the staging
    copy, issuing the pieces (graph replays, captures and the transitions
    between them), and the history pull."""
    from torch.profiler import ProfilerActivity, profile

    problem = pt_kernel_bench.large_problem("cuda")
    sched = pt_kernel_bench._circulant8()
    spec = ExecSpec(resident=True, kernel="fused", gossip="banded")

    def make():
        return algorithm.loopless_dpsvrg_algorithm(
            problem, 0.05, 40, consensus_rounds=1, batch_size=1)

    runner.run(make(), problem, sched, spec, record_every=20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = runner.run(make(), problem, sched, spec, record_every=20)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check_graphs("profile_large_d", res.extras, max_graphs(make().meta, 20))
    out = {"steps": 40, "graphs_built": res.extras["graphs_built"],
           "replays": res.extras["replays"]}
    out.update(device_busy(prof, wall_us))
    spans = {}
    for e in prof.events():
        if (e.name.startswith("resident.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            spans[e.name] = spans.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    out["host_spans_ms"] = spans
    return out


def _counted_run(algo, problem, sched, spec, record_every):
    torch.cuda.synchronize()
    before = ops.launches
    t0 = time.perf_counter()
    res = runner.run(algo, problem, sched, spec, seed=0,
                     record_every=record_every)
    torch.cuda.synchronize()
    return res, ops.launches - before, time.perf_counter() - t0


def dvr_and_auto_phase() -> None:
    """DVR fused on the banded d = 131,072 stack, at the reference bench's
    l1 weight and at ``pt_kernel_bench.MOVING_LAM`` (where the iterate
    moves: there the fused run is also held to the plain one on the card,
    and its nonzero parameters are counted), and DSPG on the paper's b=1
    ring with the default ``gossip="auto"``; each against its CPU run."""
    sched = pt_kernel_bench._circulant8()
    out = {}

    def dvr(lam):
        def make(device):
            problem = pt_kernel_bench.large_problem(device, lam=lam)
            return (algorithm.dvr_algorithm(problem, 0.05, DVR_STEPS,
                                            rho=0.5), problem)
        return make

    data, _, h, x0, _ = pt_common.setup_problem("adult_like", BENCH_SCALE,
                                                device="cuda")
    ring = graphs.b_connected_ring_schedule(8, 1)

    def dspg(device):
        if device == "cuda":
            problem = algorithm.Problem(logreg_loss, h, x0, data)
        else:
            problem = algorithm.Problem(
                logreg_loss, h, x0.cpu(),
                {k: v.cpu() for k, v in data.items()})
        return (algorithm.dspg_algorithm(
            problem, algorithm.DSPGHyperParams(alpha0=0.2),
            DSPG_AUTO_STEPS), problem)

    for name, make, schedule, spec_kw, every in (
            ("dvr_banded_fused", dvr(0.01), sched, dict(gossip="banded"), 20),
            ("dvr_banded_moving", dvr(pt_kernel_bench.MOVING_LAM), sched,
             dict(gossip="banded"), 20),
            ("dspg_ring_auto", dspg, ring, {}, 100)):
        algo, problem = make("cuda")
        spec = ExecSpec(resident=True, kernel="fused", **spec_kw)
        backend = transport.resolve_backend(spec.gossip, schedule, algo.meta)
        if name == "dspg_ring_auto" and backend.name != "banded":
            fail(f"gossip='auto' picked {backend.name!r} for DSPG on the "
                 f"b=1 ring, not 'banded'")
        res, launches, secs = _counted_run(algo, problem, schedule, spec,
                                           every)
        steps = int(res.history.steps[-1])
        if launches != steps:
            fail(f"{name}: {launches} fused_step launches for {steps} steps")
        check_graphs(name, res.extras, max_graphs(algo.meta, every))
        calgo, cproblem = make("cpu")
        cres = runner.run(calgo, cproblem, schedule,
                          spec.replace(device="cpu"), seed=0,
                          record_every=every)
        np.testing.assert_array_equal(res.extras["wire_bytes"],
                                      cres.extras["wire_bytes"])
        diff = _held_to_cpu(name, res.history.objective,
                            cres.history.objective)
        out[name] = {"backend": backend.name, "steps": steps,
                     "launches": launches, "run_s": secs,
                     "ms_per_step": secs / steps * 1e3,
                     "graphs_built": res.extras["graphs_built"],
                     "replays": res.extras["replays"],
                     "capture_s": res.extras["capture_s"],
                     "transfers_h2d": res.extras["transfers_h2d"],
                     "transfers_d2h": res.extras["transfers_d2h"],
                     "wire_bytes_last": int(res.extras["wire_bytes"][-1]),
                     "objective_first": float(res.history.objective[0]),
                     "objective_last": float(res.history.objective[-1]),
                     "nonzero": int(torch.count_nonzero(res.params)),
                     "params": res.params.numel(),
                     "max_abs_objective_vs_cpu": diff}
        if name == "dvr_banded_moving":
            if out[name]["nonzero"] == 0:
                fail(f"{name}: the iterate never left 0")
            palgo, _ = make("cuda")
            plain = runner.run(palgo, problem, schedule,
                               spec.replace(kernel="plain"), seed=0,
                               record_every=every)
            np.testing.assert_allclose(
                res.history.objective, plain.history.objective,
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name}: fused vs plain on the card")
            out[name]["max_abs_objective_fused_vs_plain"] = float(np.max(
                np.abs(res.history.objective - plain.history.objective)))
        print(f"{name} " + json.dumps(out[name]), flush=True)


# ---------------------------------------------------------------------------
# phase 9: RMSNorm and flash attention against their plain versions
# ---------------------------------------------------------------------------

# Kernel on the card vs plain version on the card.  float32: the same
# formula summed in other orders (a block reduction of x^2 in RMSNorm; FMA
# dot products and an online softmax in flash, cuBLAS and a full softmax in
# the plain version); 2e-5 is the reference's own tolerance for its flash
# kernel (tests/test_kernels.py).  bf16 RMSNorm: both round a float32
# value to bf16 and may land on neighbouring values, one bf16 ulp apart,
# at most 2^-7 = 7.8e-3 of the value.  bf16 flash: held element by element
# to ``fa_ref.bf16_bound`` against the plain version on the float32 values
# of the same bf16 inputs; the bound follows where the kernel rounds (P to
# bf16 before P V, the output to bf16).
RMS_F32_TOL = dict(rtol=1e-5, atol=1e-5)
RMS_BF16_TOL = dict(rtol=8e-3, atol=1e-5)
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-5)
RMS_ROWS = [1, 3, 4, 8, 6144]
# widths around the kernel's register tiles: ragged (1, 7: the scalar
# two-pass path), the smoke variants' 128, the models' 2304 (minicpm), 2560
# (h2o-danube) and 3584 (gemma2), and the first width past the widest row
# held in registers (two passes; 10,248 float32, 20,488 bf16)
RMS_DIMS = [1, 7, 128, 2304, 2560, 3584, "register+8"]
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
    (1, 4, 2, 130, 130, 33, True, None, None),      # hd % 4 != 0: loads
    (1, 32, 8, 6144, 6144, 80, True, 4096, None),   # h2o-danube prefill
]
DANUBE_FLASH_CASE = FLASH_CASES[-1]


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """(bound ms, what bounds it): bytes at the memory rate or operations
    at the card's peak rate for their type, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sass() -> dict:
    """HGMMA (wgmma) instructions in the built flash library, counted in
    ``cuobjdump -sass``: the toolkit's, else one on PATH, else the one in
    Triton's package.  Says why where none is found."""
    lib = _build.library_path(fa_kernel.SOURCE)
    tools = [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
             shutil.which("cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    found = [t for t in tools if t and os.access(t, os.X_OK)]
    if not found:
        return {"library": lib.name, "cuobjdump": None,
                "why": "no cuobjdump beside nvcc, on PATH or in Triton's "
                       "package"}
    proc = subprocess.run([found[0], "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        fail(f"{found[0]} -sass {lib.name}: {proc.stderr.strip()}")
    sass = proc.stdout.splitlines()
    return {"library": lib.name, "cuobjdump": found[0],
            "hgmma": sum("HGMMA" in ln for ln in sass),
            "kernels": sum("Function :" in ln for ln in sass)}


def check_rmsnorm(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(7)
    rows_out = {}
    for width in RMS_DIMS:
        for n in RMS_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                d = width if width != "register+8" else \
                    rn_kernel.max_register_d(dtype) + 8
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

                buf = torch.empty_like(x)
                row = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err,
                       "ms": graph_ms(kern), "call_ms": time_ms(kern),
                       "plain_ms": graph_ms(plain_fn),
                       "library_ms": graph_ms(
                           lambda: F.rms_norm(x, (d,), w1, 1e-6)),
                       # the memory rate's yardstick: x copied, the same
                       # bytes less w's (timed only)
                       "copy_ms": graph_ms(lambda: buf.copy_(x)),
                       "bound_ms": bnd, "bound_by": bnd_by}
                row["share_of_bound"] = bnd / row["ms"]
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
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out = fa_ops.flash_attention(q, k, v, **kw)
            over = None   # bf16: the largest share of its bound
            if dtype == torch.float32:
                plain = fa_ref.attention_ref(qt, kt, vt, **kw).transpose(1, 2)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, plain, **FLASH_F32_TOL)
                err = float((out - plain).abs().max())
            else:
                plain, limit = fa_ref.bf16_bound(qt, kt, vt, **kw)
                torch.cuda.synchronize()
                diff = (out.float() - plain.transpose(1, 2)).abs()
                over = float((diff / limit.transpose(1, 2)).max())
                err = float(diff.max())
                if not over <= 1.0:
                    fail(f"flash {case} bf16: error {err:.3g} reaches "
                         f"{over:.3g}x its element-wise bound")
                del limit, diff
            del plain
            ok = fa_ref.mask(sq, sk, causal=causal, sliding_window=win,
                             device=device)
            pairs = int(ok.sum())
            es = q.element_size()
            bnd, bnd_by = bound((2 * b * sq * h + 2 * b * sk * kv) * hd * es,
                                4 * hd * pairs * h * b, dtype)

            def kern():
                return fa_ops.flash_attention(q, k, v, **kw)

            def plain_fn():
                return fa_ref.attention_ref(qt, kt, vt, **kw)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=ok, enable_gqa=True)

            iters = 2 if big else 20
            row = {"case": list(case), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "max_err_over_bound": over,
                   "pairs": pairs,
                   "ms": graph_ms(kern, iters),
                   "call_ms": time_ms(kern, iters=iters),
                   "plain_ms": graph_ms(plain_fn, iters),
                   # the library has no softcap: no call computes that case
                   "library_ms": None if cap is not None
                   else graph_ms(library, iters),
                   "bound_ms": bnd, "bound_by": bnd_by}
            row["share_of_bound"] = bnd / row["ms"]
            rows_out[(case, row["dtype"])] = row
            print("flash_case " + json.dumps(row), flush=True)
            del q, k, v, qt, kt, vt, ok
            torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# phase 10: h2o-danube-1.8b in bf16 through the bf16 flash kernel
# ---------------------------------------------------------------------------

DANUBE_SEED = 0
DANUBE_BF16_PROMPTS = [2048, 6144]
# Both paths round the activations and P to bf16; the plain path also
# rounds the attention logits to bf16, the kernel path keeps them in
# float32, and RMSNorm sums in its own order.  Both errors against the
# float32 path are bf16 rounding compounded through 24 layers, of one
# order; a broken kernel gives errors of order 1.
BF16_ERR_RATIO = 1.5


def _prefill_ms(cfg, params, toks):
    """(last logits as float32, ms) of a prefill, timed on the host clock
    after one untimed call at the same length (first calls at a new shape
    pay for the allocator and the libraries' set-up).  The kernels' launch
    counts are set to 0 between the two calls: they count the timed one."""
    transformer.prefill(cfg, params, toks, max_len=toks.shape[1])
    torch.cuda.synchronize()
    fa_ops.launches = rn_ops.launches = 0
    t0 = time.perf_counter()
    logits, _ = transformer.prefill(cfg, params, toks,
                                    max_len=toks.shape[1])
    torch.cuda.synchronize()
    return logits.float(), (time.perf_counter() - t0) * 1e3


def danube_bf16_prefill() -> dict:
    """Phase 10: bf16 prefills of h2o-danube-1.8b at full width on the
    kernel path (the bf16 flash and RMSNorm kernels) and the plain path,
    both held to the float32 kernel path on the same weights."""
    cfg = configs.get_config("h2o-danube-1.8b").scaled(
        param_dtype="bfloat16", use_flash=True, use_fused_norm=True)
    plain_cfg = cfg.scaled(use_flash=False, use_fused_norm=False)
    f32_cfg = cfg.scaled(param_dtype="float32")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, DANUBE_SEED, device=SERVE_DEVICE)
    params32 = pytree.tree_map(lambda t: t.float(), params)
    torch.cuda.synchronize()
    print(f"danube bf16: {transformer.param_count(params)} parameters "
          f"(bf16, and a float32 copy) on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(DANUBE_SEED)
    result = {"launches": {"flash_attention": 0, "rmsnorm": 0},
              "prompts": {}}
    for n in DANUBE_BF16_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=n)
                               .astype(np.int32), device=SERVE_DEVICE)[None]
        # the bf16 kernel path: counts set to 0 just before the timed
        # prefill, read just after
        lk, kernel_ms = _prefill_ms(cfg, params, toks)
        flash_n, rms_n = fa_ops.launches, rn_ops.launches
        if (flash_n, rms_n) != (cfg.num_layers, 2 * cfg.num_layers + 1):
            fail(f"danube bf16 {n}: {flash_n} flash and {rms_n} rmsnorm "
                 f"launches, want {cfg.num_layers} and "
                 f"{2 * cfg.num_layers + 1}")
        result["launches"]["flash_attention"] += flash_n
        result["launches"]["rmsnorm"] += rms_n
        lp, plain_ms = _prefill_ms(plain_cfg, params, toks)
        lr, f32_ms = _prefill_ms(f32_cfg, params32, toks)
        for name, lg in (("kernel", lk), ("plain", lp), ("float32", lr)):
            if not bool(torch.isfinite(lg).all()) or \
                    tuple(lg.shape) != (1, cfg.vocab_size):
                fail(f"danube bf16 {n}: {name} path logits of shape "
                     f"{tuple(lg.shape)}, not all finite")
        kerr = float((lk - lr).abs().max())
        perr = float((lp - lr).abs().max())
        row = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "float32_kernel_ms": f32_ms,
               "max_abs_logit_err_kernel": kerr,
               "max_abs_logit_err_plain": perr,
               "err_ratio": kerr / perr,
               "flash_launches": flash_n, "rmsnorm_launches": rms_n,
               "greedy_kernel_vs_float32": int(lk.argmax()) ==
               int(lr.argmax())}
        result["prompts"][str(n)] = row
        print(f"danube_bf16_prefill_{n} " + json.dumps(row), flush=True)
        if not kerr <= BF16_ERR_RATIO * perr:
            fail(f"danube bf16 {n}: kernel path logit error {kerr:.3g} "
                 f"exceeds {BF16_ERR_RATIO}x the plain path's {perr:.3g}")
        del lk, lp, lr
    del params, params32
    torch.cuda.empty_cache()
    print("danube_bf16_prefill " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phases 11-13: serving h2o-danube-1.8b at full width
# ---------------------------------------------------------------------------

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
    """Phase 11.  Returns the numbers of the serving run."""
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

    # phase 12: a seeded Poisson stream through the same model
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
        print(f"--- ptxas: {source.name} "
              f"({log.count('Compiling entry function')} kernels)",
              flush=True)
        print(log.strip(), flush=True)
    print(f"build: {', '.join(s.name for s in SOURCES)} in {build_s:.1f} s "
          f"(fused_step max m {kernel.max_m()})", flush=True)
    sass = flash_sass()
    print("flash_sass " + json.dumps(sass), flush=True)
    if sass["cuobjdump"] is not None and sass["hgmma"] == 0:
        fail("the flash library holds no HGMMA instruction: the bf16 "
             "kernel does not run on the tensor cores")

    # phase 3: kernel vs plain version
    rows = check_kernel(device)
    max_err = max(r["max_abs_err"] for r in rows.values())
    print(f"kernel: all {len(rows)} cases within rtol {KERNEL_RTOL} / atol "
          f"{KERNEL_ATOL} of the plain version (max abs err {max_err:.3g})",
          flush=True)

    # phase 4: svrg_step and mix_prox vs their plain versions
    t0 = time.perf_counter()
    svrg_mix_err, svrg_mix_rows = check_svrg_mix(device)
    print(f"phase 4 (svrg_step, mix_prox): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 5: the auto threshold's measurements
    time_auto(device)

    # phase 6: the main path at full width
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
    # the same runs through the eager executor on the card
    runner.CUDA_GRAPHS = False
    eager = main_path_runs(device, parts, ds.dim, "fused")
    runner.CUDA_GRAPHS = True
    for (name, res, steps, launches, secs, most), (_, cres, _, _, csecs, _), \
            (_, eres, _, elaunches, esecs, _) in zip(gpu, cpu, eager):
        if launches != steps or elaunches != steps:
            fail(f"{name}: {launches} kernel launches (eager {elaunches}) "
                 f"for {steps} steps")
        check_history(name, res)
        check_graphs(name, res.extras, most)
        if eres.extras["replays"] != 0:
            fail(f"{name}: the eager executor replayed graphs")
        ledger = (res.extras["transfers_h2d"], res.extras["transfers_d2h"])
        if ledger != (1, 1):
            fail(f"{name}: transfer ledger {ledger}, want (1, 1)")
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(cres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name} {col}: card vs CPU")
        graph_vs_eager = 0.0
        for got, want in ((res.history.objective, eres.history.objective),
                          (res.history.consensus, eres.history.consensus),
                          (res.params.cpu().numpy(),
                           eres.params.cpu().numpy())):
            graph_vs_eager = max(graph_vs_eager,
                                 float(np.max(np.abs(got - want))))
        print(f"{name}: max_abs_graph_vs_eager {graph_vs_eager}", flush=True)
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(eres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name} {col}: graphs vs eager on the card")
        np.testing.assert_array_equal(res.history.steps, cres.history.steps)
        print("main_path " + json.dumps({
            "algorithm": name, "steps": steps, "launches": launches,
            "records": len(res.history.objective),
            "objective_first": float(res.history.objective[0]),
            "objective_last": float(res.history.objective[-1]),
            "consensus_last": float(res.history.consensus[-1]),
            "max_abs_objective_vs_cpu": float(np.max(np.abs(
                res.history.objective - cres.history.objective))),
            "max_abs_graph_vs_eager": graph_vs_eager,
            "run_s": secs, "ms_per_step": secs / steps * 1e3,
            "cpu_run_s": csecs,
            "eager_run_s": esecs, "eager_ms_per_step": esecs / steps * 1e3,
            "graphs_built": res.extras["graphs_built"],
            "max_graphs": most, "replays": res.extras["replays"],
            "capture_s": res.extras["capture_s"],
            "transfers_h2d": res.extras["transfers_h2d"],
            "transfers_d2h": res.extras["transfers_d2h"]}), flush=True)

    # phase 7: where the card's time goes on the main path
    print("profile " + json.dumps(profile_main_path(parts, ds.dim)),
          flush=True)

    # phase 8: the kernel bench at full width, DVR banded, DSPG via "auto"
    t0 = time.perf_counter()
    bench = kernel_bench_phase()
    print("profile_large_d " + json.dumps(profile_large_d()), flush=True)
    dvr_and_auto_phase()
    print(f"phase 8 (kernel bench, dvr, auto): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 9: RMSNorm and flash attention against their plain versions
    rms_rows = check_rmsnorm(device)
    flash_rows = check_flash(device)
    rms_err = max(r["max_abs_err"] for r in rms_rows.values()
                  if r["dtype"] == "float32")
    flash_err = max(r["max_abs_err"] for r in flash_rows.values()
                    if r["dtype"] == "float32")
    flash_over = max(r["max_err_over_bound"] for r in flash_rows.values()
                     if r["dtype"] == "bfloat16")
    print(f"rmsnorm: all {len(rms_rows)} cases within tolerance of the "
          f"plain version (float32 max abs err {rms_err:.3g}); flash: all "
          f"{len(flash_rows)} cases (float32 max abs err {flash_err:.3g}, "
          f"bf16 at most {flash_over:.3g} of its bound)", flush=True)

    # phase 10: h2o-danube-1.8b in bf16 through the bf16 flash kernel
    bf16_prefill = danube_bf16_prefill()

    # phases 11-12: serve h2o-danube-1.8b at full width, then a stream
    serve = serve_danube()

    # phase 13: the launcher at its smoke size
    summary = launch_serve.main(["--arch", "h2o-danube-1.8b", "--stream"])
    if summary["requests"] != 16:
        fail(f"launch.serve: {summary['requests']} requests finished")

    main_row = rows[(8, 1024, "svrg", "l1")]
    # the shape the kernel bench gives svrg_step and mix_prox
    svrg_row = svrg_mix_rows[("svrg_step", pt_kernel_bench.ROWS)]
    mix_row = svrg_mix_rows[("mix_prox", pt_kernel_bench.ROWS)]
    rms_row = rms_rows[RMS_LINE_SHAPE + ("float32",)]
    flash_row = flash_rows[(DANUBE_FLASH_CASE, "float32")]
    flash_bf16_row = flash_rows[(DANUBE_FLASH_CASE, "bfloat16")]
    flash_bf16_err = max(r["max_abs_err"] for r in flash_rows.values()
                         if r["dtype"] == "bfloat16")

    def line(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "share_of_bound": row["bound_ms"] / row["ms"]}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        line("fused_step",
             "src/repro_torch/kernels/fused_update/csrc/fused_step.cu",
             "src/repro/kernels/fused_update/kernel.py:108", main_launches,
             max_err, main_row),
        line("svrg_step",
             "src/repro_torch/kernels/fused_update/csrc/svrg_mix.cu",
             "src/repro/kernels/fused_update/kernel.py:68",
             bench["launches"]["svrg_step"], svrg_mix_err["svrg_step"],
             svrg_row),
        line("mix_prox",
             "src/repro_torch/kernels/fused_update/csrc/svrg_mix.cu",
             "src/repro/kernels/fused_update/kernel.py:75",
             bench["launches"]["mix_prox"], svrg_mix_err["mix_prox"],
             mix_row),
        line("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:37",
             serve["launches"]["rmsnorm"], rms_err, rms_row),
        line("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:106",
             serve["launches"]["flash_attention"], flash_err, flash_row),
        line("flash_attention_bf16",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:106",
             bf16_prefill["launches"]["flash_attention"], flash_bf16_err,
             flash_bf16_row),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
