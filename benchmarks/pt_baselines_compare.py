"""Extended algorithm comparison (beyond the paper's DSPG-only baseline):
DPSVRG vs DSPG vs DPG [ref 10] vs GT-SVRG [refs 18/19] at matched budgets.
The port of ``benchmarks/baselines_compare.py``.

DPG pays a full local gradient per step (n samples); the stochastic methods
are matched on inner steps.  Reported: optimality gap + effective epochs —
the cost axis on which variance reduction wins."""

from __future__ import annotations

from . import pt_common as common
from repro_torch.core import dpsvrg, graphs


def run(scale: float = 0.02, alpha: float = 0.2, device="cuda"):
    rows = []
    data, flat, h, x0, d = common.setup_problem("adult_like", scale,
                                                device=device)
    fs = common.f_star(flat, h, d)
    sched = graphs.b_connected_ring_schedule(8, b=1)
    problem = common.make_problem(data, h, x0)
    kw = dict(device=device)

    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4, num_outer=10)
    hv = common.run_algorithm("dpsvrg", problem, sched, hp, record_every=0,
                              **kw).history
    steps = int(hv.steps[-1])
    hd = common.run_algorithm("dspg", problem, sched,
                              dpsvrg.DSPGHyperParams(alpha0=alpha), steps,
                              record_every=10, **kw).history
    hg = common.run_algorithm("gt_svrg", problem, sched, alpha, 10,
                              max(steps // 10, 1), record_every=0,
                              **kw).history
    # DPG: match on EPOCHS (its per-step cost is one full epoch)
    hp_ = common.run_algorithm("dpg", problem, sched, alpha * 2,
                               int(hv.epochs[-1]) + 1, record_every=10,
                               **kw).history
    for name, hist in (("dpsvrg", hv), ("dspg", hd), ("gt_svrg", hg),
                       ("dpg", hp_)):
        rows.append(common.Row(
            f"baselines/{name}", 0.0,
            f"gap={hist.objective[-1] - fs:.5f} "
            f"epochs={hist.epochs[-1]:.1f} steps={int(hist.steps[-1])}"))
    return rows
