"""Find the serving cell's knee: the highest Poisson rate the engine
sustains without a growing backlog.

    python3 portbench/tools/knee.py --rates 4,8,12 --seconds 30 --seed 11

runs ``danube_serve_poisson`` once a rate (set-up each time, kernels built
once) and prints one JSON line a rate: TTFT p50 / p95, the median TTFT of
the window's first and second halves (a backlog that grows makes the
second far larger), finished and missed requests.  Needs the card."""

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--workload", default="danube_serve_poisson")
    args = ap.parse_args()
    for rate in (float(x) for x in args.rates.split(",")):
        res = harness.run_cell(args.workload, args.seed, args.seconds, False,
                               traffic_overrides={"rate": rate},
                               device="cuda")
        s = res["_work"]["summary"]
        print(json.dumps({"rate": rate, "correct": res["correct"],
                          "setup_s": res["metrics"]["setup_s"]["value"],
                          **{k: s[k] for k in sorted(s)}},
                         default=str), flush=True)


if __name__ == "__main__":
    main()
