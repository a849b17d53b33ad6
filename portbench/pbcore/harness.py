"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, and the result's line.

``run_cell`` does everything but look for the card, so that the tests can
drive a whole run on the CPU at a small size; ``run.py`` looks for the card
first and refuses to run without one."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time

import torch
from torch.profiler import record_function

from . import env, manifest
from .checks import Checks


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's data, the seed, the window's length,
    whether to trace, where to run, and the clock of the run's start."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    t_setup: float | None = None

    def setup_done(self) -> None:
        """Called by the driver just before its first timed unit."""
        self.sync()
        self.t_setup = time.perf_counter()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A ``record_function`` range around a call into one layer, so a
        traced window shows it beside the program's own spans; ``sync``
        waits for the card at both ends, so that it covers the device's
        work and not only its enqueueing."""
        if sync:
            self.sync()
        with record_function(name):
            yield
            if sync:
                self.sync()

    def checks(self) -> Checks:
        return Checks(self.traffic["limits"])

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    e2e: dict                 # end-to-end metric -> value (setup_s aside)
    attempted: int
    failed: int
    checks: Checks
    work: dict                # the reader's inputs: counts of the window
    counters: dict            # the program's counters
    memory_peak_bytes: int
    trace: object = None      # a trace.Trace in a traced run
    # readings of controls and planted faults, asked for by the calibration
    # tools only (traffic key "controls"); never in a benchmark run
    controls: dict = dataclasses.field(default_factory=dict)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Run cell ``name`` and return its result (the dict of the line)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.Manifest(env.ROOT)
    w = man.workload(name)
    config = dict(man.config(w["config"]), **(config_overrides or {}))
    traffic = dict(manifest.traffic(w["traffic"]), **(traffic_overrides or {}))
    run = Run(workload=w, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), t_start=t_start)
    out = manifest.driver(traffic["driver"]).run(run)
    metrics = {}
    if trace:
        ctx = {"trace": out.trace, "work": out.work, "counters": out.counters}
        for m in man.per_layer(name):
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(out.e2e, setup_s=run.t_setup - t_start)
        for m in man.end_to_end(name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.device.type == "cuda" else "cpu"),
                   "count": int(w["chips"]),
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": out.checks.correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    if out.controls:
        result["controls"] = out.controls
    result["checks"] = out.checks.as_dict()
    result["_check_lines"] = out.checks.lines()
    result["_work"] = out.work
    return result


def line(result: dict) -> str:
    """The result's line: JSON, with the numbers compared last."""
    body = {k: v for k, v in result.items() if not k.startswith("_")}
    checks = body.pop("checks")
    body["checks"] = checks
    return json.dumps(_finite(body))


def _finite(x):
    """Non-finite numbers as strings ("inf"), so the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x
