"""Fig. 1: optimality gap vs. effective epochs, DPSVRG vs DSPG, 4 datasets.
The port of ``benchmarks/fig1_convergence.py``: the same grid,
hyperparameters and derived columns.

Paper claims validated here:
  * DPSVRG converges faster (smaller gap at equal epochs),
  * DPSVRG is smooth while DSPG oscillates / stalls (inexact convergence).

Per dataset, the (multi-)seed convergence curves run through
``common.run_sweep``: with ``sweep_batched`` all seeds of a method run as
ONE batched resident run and the reported gap / oscillation are seed
means."""

from __future__ import annotations

import numpy as np

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, graphs

DATASETS = ("mnist_like", "cifar10_like", "adult_like", "covertype_like")


def sweeps(dataset: str, scale: float, device="cuda", num_outer: int = 10,
           alpha: float = 0.2, seeds: int = 1):
    """-> ({"dpsvrg": Sweep, "dspg": Sweep}, F(x*)) of one dataset: DPSVRG
    over the seeds, then DSPG over as many inner steps."""
    data, flat, h, x0, d = common.setup_problem(dataset, scale,
                                                device=device)
    fs = common.f_star(flat, h, d)
    sched = graphs.b_connected_ring_schedule(8, b=1)
    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4,
                                  num_outer=num_outer)
    seed_grid = {"seed": list(range(seeds))}

    def build_dpsvrg():
        problem = algorithm.Problem(common.logreg_loss, h, x0, data)
        return algorithm.ALGORITHMS["dpsvrg"](problem, hp), problem

    num_steps = sum(build_dpsvrg()[0].meta.outer_lengths)

    def build_dspg():
        problem = algorithm.Problem(common.logreg_loss, h, x0, data)
        return algorithm.ALGORITHMS["dspg"](
            problem, dpsvrg.DSPGHyperParams(alpha0=alpha),
            num_steps), problem

    return {"dpsvrg": common.Sweep(build_dpsvrg, seed_grid, sched, 4),
            "dspg": common.Sweep(build_dspg, seed_grid, sched, 8)}, fs


def osc(obj) -> float:
    """Oscillation: the std of the last third of each cell's trajectory,
    averaged over the cells."""
    return float(np.mean(np.std(obj[-obj.shape[0] // 3:], axis=0)))


def rows(dataset: str, sv, sd, fs: float, t_vr: float, t_ds: float):
    gap_vr = float(np.mean(sv.history.objective[-1])) - fs
    gap_ds = float(np.mean(sd.history.objective[-1])) - fs
    return [
        common.Row(f"fig1/{dataset}/dpsvrg", t_vr,
                   f"gap={gap_vr:.5f} osc={osc(sv.history.objective):.2e} "
                   f"epochs={sv.history.epochs[-1, 0]:.1f}",
                   {"gap": gap_vr, "osc": osc(sv.history.objective)}),
        common.Row(f"fig1/{dataset}/dspg", t_ds,
                   f"gap={gap_ds:.5f} osc={osc(sd.history.objective):.2e} "
                   f"speedup={gap_ds / max(gap_vr, 1e-9):.2f}x",
                   {"gap": gap_ds, "osc": osc(sd.history.objective)}),
    ]


def run(scale: float = 0.02, num_outer: int = 10, alpha: float = 0.2,
        resident: bool = False, sweep_batched: bool = False,
        seeds: int = 1, device="cuda", kernel="plain",
        datasets=DATASETS):
    out = []
    kw = dict(resident=resident, sweep_batched=sweep_batched,
              device=device, kernel=kernel)
    for dataset in datasets:
        exps, fs = sweeps(dataset, scale, device, num_outer, alpha, seeds)
        sv, us = common.timed(lambda: exps["dpsvrg"].run(**kw), device)
        steps = int(sv.history.steps[-1, 0]) * seeds
        sd, us_ds = common.timed(lambda: exps["dspg"].run(**kw), device)
        out += rows(dataset, sv, sd, fs, us / max(steps, 1),
                    us_ds / max(steps, 1))
    return out
