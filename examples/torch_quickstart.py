"""Quickstart of the PyTorch port: DPSVRG vs DSPG on l1-regularized
logistic regression, the paper's core experiment (the port of
examples/quickstart.py).

On the CUDA device (the default):

    PYTHONPATH=src python examples/torch_quickstart.py

On the CPU, or with the resident runner and the fused CUDA kernel:

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --resident
"""

import argparse

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, dpsvrg, gossip, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic


def loss_fn(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))  # Eq. 26


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--resident", action="store_true",
                        help="resident runner with the fused kernel")
    args = parser.parse_args()
    device = torch.device(args.device)

    m = 8                                   # nodes (paper testbed size)
    ds = synthetic.make_paper_dataset("adult_like", scale=0.05)
    data = params_from_numpy(synthetic.partition_per_node(ds, m), device)
    h = prox.l1(0.01)                       # the non-smooth regularizer
    schedule = graphs.b_connected_ring_schedule(m, b=1)   # ring, connected
    x0 = gossip.stack_tree(torch.zeros(ds.dim, device=device), m)
    problem = algorithm.Problem(loss_fn, h, x0, data)
    spec = ExecSpec(gossip="dense", device=args.device,
                    resident=args.resident,
                    kernel="fused" if args.resident else "plain")

    hp = dpsvrg.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4, num_outer=10)
    algo = algorithm.ALGORITHMS["dpsvrg"](problem, hp)
    hist = runner.run(algo, problem, schedule, spec, record_every=0).history
    base_algo = algorithm.ALGORITHMS["dspg"](
        problem, dpsvrg.DSPGHyperParams(alpha0=0.2), int(hist.steps[-1]))
    base = runner.run(base_algo, problem, schedule, spec,
                      record_every=10).history

    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
    _, ref = dpsvrg.centralized_prox_gd(
        loss_fn, h, torch.zeros(ds.dim, device=device), flat, 0.4, 3000)
    f_star = float(np.min(ref))
    print(f"F*                ~= {f_star:.5f}")
    print(f"DPSVRG   gap      =  {hist.objective[-1] - f_star:.5f} "
          f"(consensus {hist.consensus[-1]:.1e})")
    print(f"DSPG     gap      =  {base.objective[-1] - f_star:.5f} "
          f"(consensus {base.consensus[-1]:.1e})")
    print(f"same steps ({int(hist.steps[-1])}), constant step for DPSVRG, "
          f"decaying for DSPG — variance reduction wins.")


if __name__ == "__main__":
    main()
