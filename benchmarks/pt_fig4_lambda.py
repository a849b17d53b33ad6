"""Fig. 4: robustness to the l1 coefficient lambda in {0.001, 0.01, 0.1}.
The port of ``benchmarks/fig4_lambda.py``: the same grid, hyperparameters
and derived columns.

Paper claims: lambda barely affects DPSVRG's stability, while larger
lambda makes DSPG oscillate harder and stall at a higher loss.

The λ grid runs through ``common.run_sweep``: sequential host cells by
default, ``resident`` for sequential resident cells, ``sweep_batched`` for
the whole grid as ONE batched resident run (λ reaches each cell's prox as
its own 0-d tensor)."""

from __future__ import annotations

import numpy as np

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, graphs, prox

LAMBDAS = (0.001, 0.01, 0.1)


def sweeps(scale: float, device="cuda", alpha: float = 0.2):
    """-> {"dpsvrg": Sweep, "dspg": Sweep} over the λ grid (DSPG with a
    constant step, over as many inner steps as DPSVRG)."""
    data, flat, h, x0, d = common.setup_problem("mnist_like", scale,
                                                device=device)
    sched = graphs.b_connected_ring_schedule(8, b=1)
    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4, num_outer=9)

    def build_dpsvrg(lam=0.01):
        problem = algorithm.Problem(common.logreg_loss, prox.l1(lam), x0,
                                    data)
        return algorithm.ALGORITHMS["dpsvrg"](problem, hp), problem

    num_steps = sum(build_dpsvrg()[0].meta.outer_lengths)

    def build_dspg(lam=0.01):
        problem = algorithm.Problem(common.logreg_loss, prox.l1(lam), x0,
                                    data)
        return algorithm.ALGORITHMS["dspg"](
            problem, dpsvrg.DSPGHyperParams(alpha0=alpha,
                                            constant_step=True),
            num_steps), problem

    grid = {"lam": LAMBDAS}
    return {"dpsvrg": common.Sweep(build_dpsvrg, grid, sched, 4),
            "dspg": common.Sweep(build_dspg, grid, sched, 8)}


def osc(obj) -> float:
    return float(np.std(obj[-len(obj) // 3:]))


def rows(sv, sd):
    out = []
    for i, lam in enumerate(LAMBDAS):
        ov = sv.history.objective[:, i]
        od = sd.history.objective[:, i]
        out.append(common.Row(
            f"fig4/lambda={lam}", 0.0,
            f"loss_dpsvrg={ov[-1]:.5f} osc={osc(ov):.2e} "
            f"loss_dspg={od[-1]:.5f} osc_dspg={osc(od):.2e}",
            {"loss_dpsvrg": float(ov[-1]), "osc": osc(ov),
             "loss_dspg": float(od[-1]), "osc_dspg": osc(od)}))
    return out


def run(scale: float = 0.02, alpha: float = 0.2, resident: bool = False,
        sweep_batched: bool = False, device="cuda", kernel="plain"):
    exps = sweeps(scale, device, alpha)
    kw = dict(resident=resident, sweep_batched=sweep_batched,
              device=device, kernel=kernel)
    return rows(exps["dpsvrg"].run(**kw), exps["dspg"].run(**kw))
