"""Robustness frontier of the PyTorch port: which algorithm x compression
survives a hostile network cheapest?  The port of
examples/robustness_frontier.py.

Expands a {topology x failure x compression x algorithm} grid through
``repro_torch.scenarios.run_matrix``: every (topology, failure, seed) plane
runs as ONE batched resident sweep (one staging step and one history pull
per program — the transfer ledgers are printed), and the rows land in a
convergence-vs-wire-bytes table with the Pareto frontier starred.

On the CUDA device (the default), or on the CPU:

    PYTHONPATH=src python examples/torch_robustness_frontier.py
    PYTHONPATH=src python examples/torch_robustness_frontier.py --device cpu
"""

import argparse

import torch

from repro_torch import scenarios
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, gossip, graphs, prox
from repro_torch.data import synthetic
try:
    from examples.torch_quickstart import loss_fn
except ImportError:  # run as a script from examples/
    from torch_quickstart import loss_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=150)
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    m = 8
    ds = synthetic.make_paper_dataset("adult_like", scale=0.02)
    data = params_from_numpy(
        synthetic.partition_per_node(ds, m, heterogeneity=0.5), device)
    x0 = gossip.stack_tree(torch.zeros(ds.dim, device=device), m)
    problem = algorithm.Problem(loss_fn, prox.l1(0.01), x0, data)

    steps = args.steps
    result = scenarios.run_matrix(
        problem,
        topologies={
            "ring": graphs.static_schedule(graphs.ring_matrix(m), "ring"),
            "one-peer-expo": graphs.MixingSchedule(
                tuple(graphs.exponential_graph_matrices(m)), b=3, eta=0.5,
                name="one-peer-expo"),
        },
        failures={
            "none": [],
            "links40": [scenarios.LinkFailures(0.4)],
            "churn25": [scenarios.NodeChurn(0.25, dwell=10)],
            "stale2": [scenarios.StaleGossip(2)],
            "stragglers": [scenarios.Stragglers(3.0)],
        },
        algorithms={
            "loopless_dpsvrg": lambda p: algorithm.loopless_dpsvrg_algorithm(
                p, 0.2, steps, snapshot_prob=0.1),
            "dvr": lambda p: algorithm.dvr_algorithm(
                p, 0.2, steps, rho=0.7, snapshot_prob=0.1),
            "gt_svrg": lambda p: algorithm.gt_svrg_algorithm(
                p, 0.1, 5, steps // 5),
        },
        compressions=(None, 8),
        seeds=(0,),
        record_every=steps,
        scenario_seed=0,
        device=args.device,
    )

    print(scenarios.format_table(result.rows))
    print("\nbatched programs (one per algorithm x compression x transport "
          "spec; each runs its topology x failure x seed plane with one "
          "staging step and one pull):")
    for g in result.groups:
        print(f"  {g['algorithm']:16s} {g['compression']:5s} "
              f"delay={g['transport']['delay']} "
              f"straggler_p={g['transport']['straggler_p']:.2f}  "
              f"cells={g['cells']}  transfers h2d={g['transfers_h2d']} "
              f"d2h={g['transfers_d2h']}")
    front = scenarios.pareto_frontier(result.rows)
    best = front[-1]
    print(f"\nfrontier: {len(front)} of {len(result.rows)} cells; "
          f"best objective {best.objective:.5f} at {best.wire_bytes}B "
          f"({best.algorithm}/{best.compression} on {best.topology} "
          f"under {best.failure})")
    return result


if __name__ == "__main__":
    main()
