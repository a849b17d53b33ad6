"""Readings that set each limit of ``correct``: the program's numbers and
those of the controls, the reference put in the program's place at the
nearest precision below the configuration's (TF32 for float32 with TF32
off) and, for a training cell, with a fault planted (half of each batch
left out, the exchange between nodes left out).

    python3 portbench/tools/controls.py --workload danube_train_dpsvrg \
        --seeds 101,102,103 --seconds 5

runs the cell once a seed with a short window (the readings need none)
and prints one JSON line a seed: the numbers compared, each control's.
Needs the card; the benchmark's own runs never run the controls."""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pbcore import env  # noqa: E402

env.prepare()
env.single_threaded()

from pbcore import harness  # noqa: E402

CONTROLS = {"logreg_grid": ["tf32"], "lm_train": ["tf32", "half_batch",
                                                   "no_mix"],
            "lm_serve": ["tf32"]}


def main() -> None:
    from pbcore import manifest
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    args = ap.parse_args()
    w = manifest.Manifest().workload(args.workload)
    driver = manifest.traffic(w["traffic"])["driver"]
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               traffic_overrides={
                                   "controls": CONTROLS[driver]},
                               device="cuda")
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "controls": res.get("controls", {}),
                          "metrics": res["metrics"],
                          "device": res["device"]}), flush=True)


if __name__ == "__main__":
    main()
