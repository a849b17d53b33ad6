"""Fig. 3: multi-consensus vs single-consensus DPSVRG.  The port of
``benchmarks/fig3_consensus.py``.

Paper claims: single-consensus DPSVRG converges a little slower per
training round than multi-consensus; both are smoother/faster than DSPG."""

from __future__ import annotations

from . import pt_common as common
from repro_torch.core import dpsvrg, graphs


def run(scale: float = 0.02, alpha: float = 0.2, resident: bool = False,
        device="cuda", kernel="plain"):
    rows = []
    data, flat, h, x0, d = common.setup_problem("mnist_like", scale,
                                                device=device)
    fs = common.f_star(flat, h, d)
    sched = graphs.b_connected_ring_schedule(8, b=3, seed=0)
    problem = common.make_problem(data, h, x0)
    for name, single in (("multi", False), ("single", True)):
        hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4,
                                      num_outer=8, single_consensus=single)
        hist = common.run_algorithm("dpsvrg", problem, sched, hp,
                                    record_every=0, resident=resident,
                                    device=device, kernel=kernel).history
        rows.append(common.Row(
            f"fig3/mnist_like/{name}_consensus", 0.0,
            f"gap={hist.objective[-1] - fs:.5f} "
            f"consensus_dist={hist.consensus[-1]:.2e} "
            f"comm_rounds={int(hist.comm_rounds[-1])}"))
    return rows
