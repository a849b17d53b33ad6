"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It refuses to run without as many CUDA
cards as the cell asks for, loads and warms up the cell (set-up), measures
for ``--seconds``, holds what the window produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics from a traced
window (``--trace 1``), with the numbers compared and their limits last.
The same numbers end standard error.  See portbench/README.md."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pbcore import env  # noqa: E402

env.prepare()
env.single_threaded()

import torch  # noqa: E402

from pbcore import harness, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    chips = manifest.Manifest().workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {have}; nothing measured", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    found = env.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded forbidden modules {found}; no "
              f"result", file=sys.stderr)
        return 3
    summary = result["_work"].get("summary")
    if summary:
        print(f"serving summary: {summary}", file=sys.stderr)
    units = result["_work"].get("unit_s")
    if units:
        print("unit seconds: " + " ".join(f"{u:.4f}" for u in units),
              file=sys.stderr)
    for text in result["_check_lines"]:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(harness.line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
