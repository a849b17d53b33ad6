"""Fig. 5: graph-connectivity sweep b in {1, 3, 7, 50} (time-varying
graphs).  The port of ``benchmarks/fig5_connectivity.py``: the same grid,
hyperparameters and derived columns.

Paper claims: sparser (larger-b) graphs slow both algorithms and widen the
DPSVRG-DSPG gap; sparsity slows DPSVRG but does NOT prevent convergence.

The connectivity grid is a ``"schedule"`` sweep axis, zip-paired with the
per-b seeds: ``sweep_batched`` runs all four topologies as ONE batched
dense resident run, with one mixing matrix a cell."""

from __future__ import annotations

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, graphs

BS = (1, 3, 7, 50)


def sweeps(scale: float, device="cuda", alpha: float = 0.2):
    """-> ({"dpsvrg": Sweep, "dspg": Sweep}, F(x*)) over the b grid."""
    data, flat, h, x0, d = common.setup_problem("mnist_like", scale,
                                                device=device)
    fs = common.f_star(flat, h, d)
    scheds = [graphs.b_connected_ring_schedule(8, b=b, seed=b) for b in BS]
    grid = {"schedule": scheds, "seed": list(BS)}
    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4, num_outer=9)

    def build_dpsvrg():
        problem = algorithm.Problem(common.logreg_loss, h, x0, data)
        return algorithm.ALGORITHMS["dpsvrg"](problem, hp), problem

    num_steps = sum(build_dpsvrg()[0].meta.outer_lengths)

    def build_dspg():
        problem = algorithm.Problem(common.logreg_loss, h, x0, data)
        return algorithm.ALGORITHMS["dspg"](
            problem, dpsvrg.DSPGHyperParams(alpha0=alpha),
            num_steps), problem

    return {"dpsvrg": common.Sweep(build_dpsvrg, grid, None, 0, "zip"),
            "dspg": common.Sweep(build_dspg, grid, None, 10, "zip")}, fs


def rows(sv, sd, fs: float):
    out = []
    for i, b in enumerate(BS):
        gv = float(sv.history.objective[-1, i]) - fs
        gd = float(sd.history.objective[-1, i]) - fs
        out.append(common.Row(
            f"fig5/b={b}", 0.0,
            f"gap_dpsvrg={gv:.5f} gap_dspg={gd:.5f} "
            f"widening={gd - gv:.5f} "
            f"consensus={sv.history.consensus[-1, i]:.2e}",
            {"gap_dpsvrg": gv, "gap_dspg": gd, "widening": gd - gv,
             "consensus": float(sv.history.consensus[-1, i])}))
    return out


def run(scale: float = 0.02, alpha: float = 0.2, resident: bool = False,
        sweep_batched: bool = False, device="cuda", kernel="plain"):
    exps, fs = sweeps(scale, device, alpha)
    kw = dict(resident=resident, sweep_batched=sweep_batched,
              device=device, kernel=kernel)
    return rows(exps["dpsvrg"].run(**kw), exps["dspg"].run(**kw), fs)
