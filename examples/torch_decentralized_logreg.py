"""The paper's full experimental setting with the PyTorch port: time-varying
graphs, multi- vs single-consensus, lambda sweep — a runnable mini version
of Figs. 1-5.  The port of examples/decentralized_logreg.py, with its
settings and print format.

Each run is resident with ``kernel="auto"``: on the CUDA device (the
default) the steps go through the fused resident-step kernel.

    PYTHONPATH=src python examples/torch_decentralized_logreg.py [--scale 0.02]
    PYTHONPATH=src python examples/torch_decentralized_logreg.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, dpsvrg, gossip, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
try:
    from examples.torch_quickstart import loss_fn
except ImportError:  # run as a script from examples/
    from torch_quickstart import loss_fn


def run_setting(dataset, m, b, lam, alpha, num_outer, scale, single=False,
                device="cuda"):
    ds = synthetic.make_paper_dataset(dataset, scale=scale)
    data = params_from_numpy(synthetic.partition_per_node(ds, m), device)
    h = prox.l1(lam)
    sched = graphs.b_connected_ring_schedule(m, b=b, seed=b)
    x0 = gossip.stack_tree(torch.zeros(ds.dim, device=device), m)
    problem = algorithm.Problem(loss_fn, h, x0, data)
    spec = ExecSpec(resident=True, kernel="auto", device=device)
    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4,
                                  num_outer=num_outer,
                                  single_consensus=single)
    hv = runner.run(algorithm.ALGORITHMS["dpsvrg"](problem, hp), problem,
                    sched, spec, record_every=0).history
    hd = runner.run(
        algorithm.ALGORITHMS["dspg"](
            problem, dpsvrg.DSPGHyperParams(alpha0=alpha),
            int(hv.steps[-1])),
        problem, sched, spec, seed=b, record_every=10).history
    return hv, hd


def main(argv=None) -> dict:
    """Runs the three sections; returns {(section, value): (DPSVRG history,
    DSPG history)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    runs = {}

    print("== graph connectivity sweep (Fig. 5): b in {1, 3, 7} ==")
    for b in (1, 3, 7):
        hv, hd = runs["fig5", b] = run_setting(
            "mnist_like", 8, b, 0.01, 0.2, 9, args.scale, device=device)
        print(f"  b={b}: DPSVRG F={hv.objective[-1]:.5f} "
              f"(consensus {hv.consensus[-1]:.1e})  "
              f"DSPG F={hd.objective[-1]:.5f}")

    print("== lambda sweep (Fig. 4) ==")
    for lam in (0.001, 0.01, 0.1):
        hv, hd = runs["fig4", lam] = run_setting(
            "mnist_like", 8, 1, lam, 0.2, 9, args.scale, device=device)
        osc = float(np.std(hd.objective[-4:]))
        print(f"  lam={lam}: DPSVRG F={hv.objective[-1]:.5f}  "
              f"DSPG F={hd.objective[-1]:.5f} (osc {osc:.1e})")

    print("== multi vs single consensus (Fig. 3) ==")
    for single in (False, True):
        hv, _ = runs["fig3", single] = run_setting(
            "mnist_like", 8, 3, 0.01, 0.2, 9, args.scale, single=single,
            device=device)
        print(f"  {'single' if single else 'multi '}: "
              f"F={hv.objective[-1]:.5f} consensus={hv.consensus[-1]:.1e} "
              f"comm={int(hv.comm_rounds[-1])}")
    return runs


if __name__ == "__main__":
    main()
