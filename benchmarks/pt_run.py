"""The port's entry point to the paper's tables and figures: the port of
``benchmarks/run.py``.

    PYTHONPATH=src python -m benchmarks.pt_run --only fig4 --device cpu \\
        --scale 0.02
    PYTHONPATH=src python -m benchmarks.pt_run --sweep-batched --scale 1.0

Prints ``name,us_per_call,derived`` CSV.  ``--scale`` shrinks the Table I
dataset sizes (default 0.02; 1.0 is the paper's size, for the card).
``--resident`` drives the figure sweeps through the resident runner,
``--sweep-batched`` runs each figure's grid (seeds, λ, connectivity) as ONE
batched resident run, ``--kernel fused`` swaps the fused step's CUDA kernel
into the resident runs.  ``beyond`` runs the scenario matrix of
``benchmarks/pt_beyond_noniid.py`` (its programs are batched sweeps in
every mode).  ``runner`` runs the runner bench of
``benchmarks/pt_runner_bench.py`` (host loop, scan, resident with host and
device sampling, the transports, the LM trainer).  Runs on the CUDA device
unless given ``--device cpu``; without a card it raises.  The kernel bench
is ``benchmarks/pt_kernel_bench.py``."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--only", default="",
                    help="comma-separated subset: table1,fig1,fig2,fig3,"
                         "fig4,fig5,beyond,baselines,runner")
    ap.add_argument("--resident", action="store_true",
                    help="drive the figure sweeps through the resident "
                         "runner (one staging step and one pull a run)")
    ap.add_argument("--sweep-batched", action="store_true",
                    help="run each figure grid (λ / connectivity / seeds) "
                         "as ONE batched resident run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel", default="plain",
                    choices=("plain", "fused", "auto"),
                    help="the resident step: plain, or the fused kernel")
    args = ap.parse_args(argv)

    from . import (pt_baselines_compare, pt_beyond_noniid, pt_common,
                   pt_datasets_table, pt_fig1_convergence, pt_fig2_comm,
                   pt_fig3_consensus, pt_fig4_lambda, pt_fig5_connectivity,
                   pt_runner_bench)
    device = pt_common.require_device(args.device)
    suites = {
        "table1": pt_datasets_table.run,
        "fig1": pt_fig1_convergence.run,
        "fig2": pt_fig2_comm.run,
        "fig3": pt_fig3_consensus.run,
        "fig4": pt_fig4_lambda.run,
        "fig5": pt_fig5_connectivity.run,
        "beyond": pt_beyond_noniid.run,
        "baselines": pt_baselines_compare.run,
        "runner": pt_runner_bench.run,
    }
    only = {s for s in args.only.split(",") if s}
    unknown = only - set(suites)
    if unknown:
        raise SystemExit(f"unknown suites {sorted(unknown)}; have "
                         f"{sorted(suites)}")
    resident_aware = {"fig1", "fig2", "fig3", "fig4", "fig5"}
    sweep_aware = {"fig1", "fig4", "fig5"}
    print("name,us_per_call,derived")
    for name, fn in suites.items():
        if only and name not in only:
            continue
        t0 = time.time()
        kw = {"device": device}
        if name in resident_aware:
            kw["resident"] = args.resident
            kw["kernel"] = args.kernel
        if args.sweep_batched and name in sweep_aware:
            kw["sweep_batched"] = True
        for r in fn(args.scale, **kw):
            print(f"{r.name},{r.us_per_call:.1f},{r.derived}", flush=True)
        print(f"{name}/total_wall_s,{(time.time() - t0) * 1e6:.0f},",
              file=sys.stderr)


if __name__ == "__main__":
    main()
