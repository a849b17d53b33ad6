"""Kernel benchmark of the PyTorch port: the port of
``benchmarks/kernel_bench.py``.

    python -m benchmarks.pt_kernel_bench [--device cuda|cpu] [--scale S]
    python -m benchmarks.pt_kernel_bench --json [PATH]

``run()`` times, on (2048, 1024) float32 buffers (8 MiB a stream):

* the unfused torch chain the kernels replace (the SVRG step and the l1
  prox as separate tensor operations);
* the plain svrg_step -> mix_prox chain (``kernels.fused_update.ref``);
* the CUDA ``svrg_step`` and ``mix_prox`` kernels, each alone and chained,
  each held against its plain version on the same inputs (max abs err);

and then the resident rows of ``kernel_stats``.  Kernel times on the card
are CUDA events around repeated eager calls after a warm-up; each row's
``data["calls"]`` counts every call it made to a kernel wrapper, so that a
caller can hold the wrappers' launch counts to them.  The bound is the
bytes each call must move over the H100's 3.35 TB/s.

``kernel_stats()`` times the fused resident step end to end through
``runner.run(ExecSpec(resident=True, kernel=...))``:

* paper scale: DSPG, 600 steps, ``adult_like`` (d = 30), m = 8, a b=2
  ring, dense gossip, with ``kernel="plain" | "auto" | "fused"`` (the
  reference's ``xla`` / ``auto`` / ``pallas``);
* large d: loopless DPSVRG on ``_circulant8`` (a 5-band 2-hop ring) with
  ``gossip="banded"`` at d = 131,072, plain vs fused; the banded phi
  lowers to the fused kernel's mix matrix, and the fused run's launch
  count (on a card) equals its inner steps;

* large d, moving: the same loopless DPSVRG runs on the same stack with
  l1 at ``MOVING_LAM`` = 1e-4 (untimed).  At the reference's lam = 0.01
  every coordinate's step stays under the l1 threshold at d = 131,072 and
  the iterate never leaves 0, so that row's histories compare zeros; at
  1e-4 it moves, and ``nonzero`` counts the fused run's nonzero final
  parameters (the section raises if it is 0);

with the fused histories held to the plain ones at rtol 1e-4 / atol 1e-6,
as the reference holds them, plus the buffer-level step (``_step_buf_
stats``).  Each fused run reports its CUDA graphs (``graphs_built``,
``replays``; 0 off the card).  ``--json`` MERGES that dict as a ``"kernels"`` section into
PATH (default ``BENCH_torch.json``), keeping the file's other sections.

Runs on the CUDA device by default; without a card it raises unless given
``--device cpu``, where the wrappers run their plain versions (no kernel
launches) and the times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, gossip, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.kernels.fused_update import ops as fu_ops, ref as fu_ref
from repro_torch.launch import roofline

HBM_BYTES_PER_S = roofline.HW().hbm_bw     # H100 SXM device memory
LARGE_D = 131072
MOVING_LAM = 1e-4             # an l1 weight at which the large-d iterate moves
ROWS = 2048                   # (2048, 1024) float32: 8 MiB per stream
ALPHA, THRESH = 0.05, 0.01
W_MIX = (1 / 3, 1 / 3, 1 / 3)
WARMUP, ITERS = 3, 20


def _time_us(fn, device, iters: int = ITERS) -> tuple[float, int]:
    """(us per call, calls made): ``WARMUP`` calls, then ``iters`` timed
    calls between CUDA events (host clock on the CPU)."""
    for _ in range(WARMUP):
        fn()
    common.sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        us = start.elapsed_time(stop) * 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / iters
    return us, WARMUP + iters


def _bound_us(streams: int, n: int) -> float:
    return streams * n * 4 / HBM_BYTES_PER_S * 1e6


def run(scale: float = 0.02, device="cuda", rows: int = ROWS,
        large_d: int = LARGE_D, paper_steps: int = 600) -> list:
    device = common.require_device(device)
    out = []
    rng = np.random.default_rng(0)
    shp = (rows, 1024)
    x, gn, gs, mu = (torch.as_tensor(rng.normal(size=shp), dtype=torch.float32,
                                     device=device) for _ in range(4))
    n = x.numel()
    on_card = device.type == "cuda"
    what = "kernel" if on_card else "plain version (CPU)"

    def unfused():
        q = x - ALPHA * (gn - gs + mu)
        return torch.sign(q) * torch.clamp_min(torch.abs(q) - THRESH, 0.0)

    def plain_chain():
        return fu_ref.mix_prox_ref(fu_ref.svrg_step_ref(x, gn, gs, mu, ALPHA),
                                   x, x, *W_MIX, THRESH)

    def k_svrg():
        return fu_ops.svrg_step(x, gn, gs, mu, ALPHA)

    def k_mix():
        return fu_ops.mix_prox(x, gn, gs, *W_MIX, THRESH)

    def k_chain():
        return fu_ops.mix_prox(fu_ops.svrg_step(x, gn, gs, mu, ALPHA), x, x,
                               *W_MIX, THRESH)

    us, _ = _time_us(unfused, device)
    out.append(common.Row("kernel/unfused_chain_torch", us,
                          f"streams=5 bytes={5 * n * 4}"))
    us, _ = _time_us(plain_chain, device)
    b_svrg, b_mix = _bound_us(5, n), _bound_us(4, n)
    out.append(common.Row(
        "kernel/plain_chain", us,
        f"H100 bound_us={b_svrg + b_mix:.2f} (svrg {b_svrg:.2f} + mix_prox "
        f"{b_mix:.2f}, bytes / 3.35 TB/s)" if on_card else what))

    # each kernel against its plain version on the same inputs
    err_svrg = float((k_svrg() - fu_ref.svrg_step_ref(x, gn, gs, mu, ALPHA))
                     .abs().max())
    err_mix = float((k_mix() - fu_ref.mix_prox_ref(x, gn, gs, *W_MIX,
                                                   THRESH)).abs().max())
    err_chain = float((k_chain() - plain_chain()).abs().max())
    out.append(common.Row(
        "kernel/svrg_mix_check", 0.0,
        f"max_abs_err svrg_step={err_svrg:.1e} mix_prox={err_mix:.1e} "
        f"chain={err_chain:.1e} ({what} vs plain version)",
        {"calls": {"svrg_step": 2, "mix_prox": 2},
         "max_abs_err": {"svrg_step": err_svrg, "mix_prox": err_mix,
                         "chain": err_chain}}))
    for name, fn, calls, bound in (
            ("svrg_step", k_svrg, {"svrg_step": 1}, b_svrg),
            ("mix_prox", k_mix, {"mix_prox": 1}, b_mix),
            ("svrg_mix_chain", k_chain, {"svrg_step": 1, "mix_prox": 1},
             b_svrg + b_mix)):
        us, made = _time_us(fn, device)
        # the H100's bound is a device number: no share of it for the CPU
        derived = (f"kernel bound_us={bound:.2f} share={bound / us:.2f}"
                   if on_card else what)
        out.append(common.Row(
            f"kernel/{name}", us, derived,
            {"calls": {k: v * made for k, v in calls.items()},
             "bound_us": bound}))

    ks = kernel_stats(scale, device, large_d=large_d, paper_steps=paper_steps)
    ps, ld = ks["paper_scale"], ks["large_d"]
    out.append(common.Row(
        "kernel/resident_paper_scale_auto", ps["auto_ms_per_step"] * 1e3,
        f"d={ps['param_dim']} plain={ps['plain_ms_per_step'] * 1e3:.1f}"
        f"us/step fused={ps['fused_ms_per_step'] * 1e3:.1f}us/step "
        f"auto_bitwise_plain={ps['auto_matches_plain_bitwise']}", ps))
    out.append(common.Row(
        "kernel/resident_large_d_fused", ld["fused_ms_per_step"] * 1e3,
        f"d={ld['param_dim']} banded, fused speedup="
        f"{ld['speedup_fused_vs_plain']:.2f}x vs plain "
        f"({ld['plain_ms_per_step']:.3f} ms/step), hist_diff="
        f"{ld['history_max_abs_diff']:.1e}", ld))
    mv = ks["large_d_moving"]
    out.append(common.Row(
        "kernel/resident_large_d_moving", 0.0,
        f"d={mv['param_dim']} lam={mv['lam']} nonzero={mv['nonzero']}/"
        f"{mv['params']} fused vs plain hist_diff="
        f"{mv['history_max_abs_diff']:.1e}", mv))
    out.append(common.Row("kernel/step_buf", 0.0,
                          json.dumps(ks["step_buf"]), ks["step_buf"]))
    return out


# ---------------------------------------------------------------------------
# the "kernels" section (merged into BENCH_torch.json)
# ---------------------------------------------------------------------------

def _step_buf_stats(device, large_d: int = LARGE_D) -> dict:
    """The buffer-level fused step (``fused_step_buf``) against the unfused
    expression it replaces at the paper-scale and the large stacked
    shapes, and its max abs diff to its plain version."""
    out: dict = {}
    for label, (m, d) in (("paper", (8, 30)), ("large", (8, large_d))):
        rng = np.random.default_rng(0)
        x, gn, gs, mu = streams = tuple(
            torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                            device=device) for _ in range(4))
        w = torch.as_tensor(rng.dirichlet(np.ones(m), size=m),
                            dtype=torch.float32, device=device)
        alpha, lam = 0.05, 0.01

        def fused():
            return fu_ops.fused_step_buf(w, streams, alpha, lam,
                                         rule="svrg", prox_kind="l1")

        def unfused():
            # separate correction, dense mix and prox passes
            z = w @ (x - alpha * (gn - gs + mu))
            return torch.sign(z) * torch.clamp_min(
                torch.abs(z) - alpha * lam, 0.0)

        t_fused, _ = _time_us(fused, device)
        t_plain, _ = _time_us(unfused, device)
        diff = float((fused() - fu_ref.fused_step_math(
            w, streams, alpha, lam, rule="svrg", prox_kind="l1"))
            .abs().max())
        out[label] = {"shape": [m, d], "fused_us": t_fused,
                      "plain_us": t_plain, "plain_max_abs_diff": diff}
    return out


def _circulant8() -> graphs.MixingSchedule:
    """Static 5-band circulant mixing matrix on 8 nodes (self 0.4, +-1 0.2,
    +-2 0.1): a 2-hop ring whose BandedPhi and dense forms both lower to the
    fused kernel's mix matrix."""
    w = np.zeros((8, 8))
    for off, c in ((0, 0.4), (1, 0.2), (-1, 0.2), (2, 0.1), (-2, 0.1)):
        w[np.arange(8), (np.arange(8) + off) % 8] += c
    return graphs.static_schedule(w, name="circulant8_5band")


def large_problem(device, d: int = LARGE_D, m: int = 8, n_i: int = 4,
                  lam: float = 0.01) -> algorithm.Problem:
    """The large-d stack of the reference's bench: m nodes with n_i samples
    of d features each (N(0, 1/d)), labels in {-1, +1}, l1 at ``lam``."""
    rng = np.random.default_rng(0)
    data = {"features": torch.as_tensor(
        rng.normal(size=(m, n_i, d)) / np.sqrt(d), dtype=torch.float32,
        device=device),
        "labels": torch.as_tensor(
            rng.integers(0, 2, size=(m, n_i)) * 2.0 - 1.0,
            dtype=torch.float32, device=device)}
    x0 = gossip.stack_tree(torch.zeros(d, device=device), m).contiguous()
    return algorithm.Problem(common.logreg_loss, prox.l1(lam), x0, data)


def _run_counted(algo, problem, sched, spec, record_every):
    """(result, fused_step launches made by the run)."""
    before = fu_ops.launches
    res = runner.run(algo, problem, sched, spec, seed=0,
                     record_every=record_every)
    common.sync(spec.device)
    return res, fu_ops.launches - before


def kernel_stats(scale: float = 0.02, device="cuda", *,
                 large_d: int = LARGE_D, paper_steps: int = 600,
                 timed: bool = True) -> dict:
    """The ``"kernels"`` section: plain / auto / fused resident ms per step
    at paper scale and plain / fused at the large banded stack, the
    histories (``objective``), the fused runs' kernel launches, and the
    buffer-level stats.  ``timed=False`` skips the timing runs (ms fields
    None), for a reference run of the same histories."""
    device = common.require_device(device)

    def timer(make, problem, sched, **kw):
        if not timed:
            return None
        return common._time_run(make(), problem, sched, device=device,
                                **kw) / 1e3

    # --- paper scale ------------------------------------------------------
    data, _, h, x0, d = common.setup_problem("adult_like", scale,
                                             device=device)
    sched = graphs.b_connected_ring_schedule(8, b=2, seed=0)
    problem = algorithm.Problem(common.logreg_loss, h, x0, data)
    steps = paper_steps

    def make():
        return algorithm.dspg_algorithm(
            problem, dpsvrg.DSPGHyperParams(alpha0=0.2), num_steps=steps)

    kw = dict(record_every=100, resident=True, gossip="dense")
    t = {k: timer(make, problem, sched, kernel=k, **kw)
         for k in ("plain", "auto", "fused")}
    spec = ExecSpec(resident=True, gossip="dense", device=device)
    r = {k: _run_counted(make(), problem, sched, spec.replace(kernel=k), 100)
         for k in ("plain", "auto", "fused")}
    obj = {k: v[0].history.objective for k, v in r.items()}
    np.testing.assert_allclose(obj["fused"], obj["plain"], rtol=1e-4,
                               atol=1e-6)
    paper = {
        "algorithm": "dspg", "steps": steps, "m": 8, "param_dim": int(d),
        "schedule": "bring8_b2", "scale": scale, "device": str(device),
        "plain_ms_per_step": t["plain"] and t["plain"] / steps,
        "auto_ms_per_step": t["auto"] and t["auto"] / steps,
        "fused_ms_per_step": t["fused"] and t["fused"] / steps,
        "auto_picks_fused": fu_ops.fused_wins(d),
        "auto_matches_plain_bitwise": bool(np.array_equal(obj["plain"],
                                                          obj["auto"])),
        "history_max_abs_diff": float(np.max(np.abs(obj["plain"]
                                                    - obj["fused"]))),
        **_run_figures(r["fused"]),
        "objective": {k: v.tolist() for k, v in obj.items()},
    }

    # --- large d: loopless DPSVRG on the banded ring transport --------------
    # The unfused step pays one shifted pass per band for the mix on top of
    # the separate SVRG-correction and prox passes; the fused step lowers
    # the BandedPhi to the dense mix matrix and does the update in one
    # kernel launch.
    m, stepsL = 8, 40
    problemL = large_problem(device, large_d, m)
    schedL = _circulant8()

    def makeL():
        return algorithm.loopless_dpsvrg_algorithm(
            problemL, 0.05, stepsL, consensus_rounds=1, batch_size=1)

    kwL = dict(record_every=20, resident=True, gossip="banded")
    tL = {k: timer(makeL, problemL, schedL, kernel=k, **kwL)
          for k in ("plain", "fused")}
    specL = ExecSpec(resident=True, gossip="banded", device=device)
    rL = {k: _run_counted(makeL(), problemL, schedL,
                          specL.replace(kernel=k), 20)
          for k in ("plain", "fused")}
    objL = {k: v[0].history.objective for k, v in rL.items()}
    np.testing.assert_allclose(objL["fused"], objL["plain"], rtol=1e-4,
                               atol=1e-6)
    large = {
        "algorithm": "loopless_dpsvrg", "steps": stepsL, "m": m,
        "param_dim": int(large_d), "schedule": schedL.name,
        "gossip": "banded", "device": str(device),
        "plain_ms_per_step": tL["plain"] and tL["plain"] / stepsL,
        "fused_ms_per_step": tL["fused"] and tL["fused"] / stepsL,
        "speedup_fused_vs_plain": (tL["plain"] / tL["fused"]
                                   if timed else None),
        "history_max_abs_diff": float(np.max(np.abs(objL["plain"]
                                                    - objL["fused"]))),
        **_run_figures(rL["fused"]),
        "objective": {k: v.tolist() for k, v in objL.items()},
    }

    # --- large d at an l1 weight where the iterate moves --------------------
    problemM = large_problem(device, large_d, m, lam=MOVING_LAM)

    def makeM():
        return algorithm.loopless_dpsvrg_algorithm(
            problemM, 0.05, stepsL, consensus_rounds=1, batch_size=1)

    rM = {k: _run_counted(makeM(), problemM, schedL,
                          specL.replace(kernel=k), 20)
          for k in ("plain", "fused")}
    objM = {k: v[0].history.objective for k, v in rM.items()}
    np.testing.assert_allclose(objM["fused"], objM["plain"], rtol=1e-4,
                               atol=1e-6)
    nonzero = int(torch.count_nonzero(rM["fused"][0].params))
    if nonzero == 0:
        raise RuntimeError(
            f"the large-d run at lam={MOVING_LAM} never left 0: its "
            f"fused-against-plain check compares zeros")
    moving = {
        "algorithm": "loopless_dpsvrg", "steps": stepsL, "m": m,
        "param_dim": int(large_d), "lam": MOVING_LAM, "gossip": "banded",
        "device": str(device), "nonzero": nonzero,
        "params": m * int(large_d),
        "history_max_abs_diff": float(np.max(np.abs(objM["plain"]
                                                    - objM["fused"]))),
        **_run_figures(rM["fused"]),
        "objective": {k: v.tolist() for k, v in objM.items()},
    }
    return {"paper_scale": paper, "large_d": large, "large_d_moving": moving,
            "step_buf": _step_buf_stats(device, large_d) if timed else None}


def _run_figures(counted) -> dict:
    """The fused run's launches, transfer ledger and CUDA graphs."""
    res, launches = counted
    return {"fused_launches": launches,
            **{k: int(res.extras[k]) for k in (
                "transfers_h2d", "transfers_d2h", "graphs_built",
                "replays")}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--json", nargs="?", const="BENCH_torch.json",
                    default=None, metavar="PATH",
                    help="MERGE the resident stats as a 'kernels' section "
                         "into PATH (default BENCH_torch.json), keeping its "
                         "other sections")
    args = ap.parse_args(argv)
    device = common.require_device(args.device)
    if args.json:
        out = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                out = json.load(f)
        out["kernels"] = kernel_stats(args.scale, device)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        ps, ld = out["kernels"]["paper_scale"], out["kernels"]["large_d"]
        print(f"wrote {args.json} (kernels section, device {device})")
        print(f"  paper(d={ps['param_dim']})  plain="
              f"{ps['plain_ms_per_step']:.4f} auto="
              f"{ps['auto_ms_per_step']:.4f} fused="
              f"{ps['fused_ms_per_step']:.4f} ms/step")
        print(f"  large(d={ld['param_dim']}) plain="
              f"{ld['plain_ms_per_step']:.3f} fused="
              f"{ld['fused_ms_per_step']:.3f} ms/step "
              f"({ld['speedup_fused_vs_plain']:.2f}x, hist_diff="
              f"{ld['history_max_abs_diff']:.1e})")
    else:
        print("name,us_per_call,derived")
        for r in run(args.scale, device):
            print(f"{r.name},{r.us_per_call:.1f},{r.derived}")


if __name__ == "__main__":
    main()
