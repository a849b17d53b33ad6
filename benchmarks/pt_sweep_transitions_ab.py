#!/usr/bin/env python3
"""How a batched sweep runs its outer transitions and records, timed both
ways in turns on one card.

    python3 benchmarks/pt_sweep_transitions_ab.py

A batched sweep (``core/sweep.py``) runs the steps of every cell under one
``torch.func.vmap`` over the cells, and its transitions (full gradients
over the dataset) and records (objectives over it) cell by cell between
pieces (``sweep._each_cell``).  The other way, the one this script times
against it, runs them under the same vmap as the steps
(``sweep._over_cells``): fewer host operations, but PyTorch's batching rule
for the product of the shared dataset with the cells' iterates copies the
dataset once per cell.  For the figure sweeps of ``chip_smoke.py``'s phase
15 at scale 1.0 (Figs. 4 and 5, Fig. 1 on mnist_like and covertype_like),
this runs each sweep batched through the fused kernel in turns (cell by
cell, vmapped, vmapped, cell by cell) and prints one ``sweep_transitions``
JSON line a sweep: ms per cell-step of each turn, the peak device memory
above what was allocated before, and a traced run of each way (wall time,
device busy time, idle share, the sweep's host spans).  Needs one card.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402

FIGURES = ("fig4", "fig5", "fig1/mnist_like", "fig1/covertype_like")


def vmapped(built, fn, tree, which=None):
    """The transitions and records under one vmap over the cells, each
    cell's algorithm rebuilt from its own 0-d values."""
    if which is not None:
        raise ValueError("the figure sweeps flip no coins")
    return sweep._over_cells(vmapped.build, fn, tree, vmapped.values)


def main() -> None:
    if not chip_smoke.torch.cuda.is_available():
        chip_smoke.fail("this A/B needs a CUDA card")
    _build.build(SOURCES)
    cell_by_cell = sweep._each_cell
    ways = {"cell_by_cell": cell_by_cell, "vmapped": vmapped}
    for fig, method, sw, _ in chip_smoke.figure_sweeps("cuda", 1.0):
        if fig not in FIGURES:
            continue
        names = [k for k in sw.grid if k not in ("seed", "schedule")]
        cells = sweep.expand_grid(sw.grid, sw.mode)
        vmapped.build = sw.build
        vmapped.values = {
            k: chip_smoke.torch.tensor([c[k] for c in cells],
                                       dtype=chip_smoke.torch.float32,
                                       device="cuda") for k in names}
        out = {"sweep": f"{fig}/{method}", "cells": len(cells)}
        try:
            for way in ("cell_by_cell", "vmapped", "vmapped",
                        "cell_by_cell"):
                sweep._each_cell = ways[way]
                res, secs, peak = chip_smoke._timed_sweep(
                    sw, "cuda", sweep_batched=True, kernel="fused")
                steps = int(res.history.steps[-1, 0])
                out.setdefault(f"{way}_ms_per_cell_step", []).append(
                    secs / (steps * len(cells)) * 1e3)
                out[f"{way}_peak_gb"] = peak
            for way in ("cell_by_cell", "vmapped"):
                sweep._each_cell = ways[way]
                prof = chip_smoke.profile_sweep(sw, f"{fig}/{method}")
                out[f"{way}_profile"] = {
                    k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                         "device_idle_share",
                                         "host_spans_ms")}
        finally:
            sweep._each_cell = cell_by_cell
        print("sweep_transitions " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
