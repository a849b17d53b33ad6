"""Time-varying topology deep-dive with the PyTorch port: watch consensus +
convergence as the communication graph flaps (the paper's Section V-D
scenario, plus a link that degrades mid-training as a seeded
``repro_torch.scenarios`` event model).  The port of
examples/timevarying_topology.py.

On the CUDA device (the default), or on the CPU:

    PYTHONPATH=src python examples/torch_timevarying_topology.py
    PYTHONPATH=src python examples/torch_timevarying_topology.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, dpsvrg, gossip, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
try:
    from examples.torch_quickstart import loss_fn
except ImportError:  # run as a script from examples/
    from torch_quickstart import loss_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-outer", type=int, default=8,
                        help="DPSVRG outer rounds of each schedule's run")
    parser.add_argument("--steps", type=int, default=200,
                        help="steps of the stale+straggler run")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    m = 8
    ds = synthetic.make_paper_dataset("covertype_like", scale=0.02)
    data = params_from_numpy(synthetic.partition_per_node(ds, m), device)
    h = prox.l1(0.01)
    x0 = gossip.stack_tree(torch.zeros(ds.dim, device=device), m)
    problem = algorithm.Problem(loss_fn, h, x0, data)
    matchings = graphs.edge_matching_matrices(m)
    tdma = graphs.MixingSchedule(tuple(matchings), b=len(matchings), eta=0.5,
                                 name="tdma-matchings")
    ring = graphs.static_schedule(graphs.ring_matrix(m), "static-ring")

    # benign schedules plus the SAME ring degraded by seeded network events:
    # scenarios.apply composes link-failure / churn models over any base
    # schedule, Metropolis-reweighting every realized W^t so Assumption 2
    # (double stochasticity) survives the degradation
    cases = [
        (graphs.static_schedule(graphs.fully_connected_matrix(m),
                                "complete"), []),
        (ring, []),
        (tdma, []),
        (graphs.MixingSchedule(tuple(graphs.exponential_graph_matrices(m)),
                               b=3, eta=0.5, name="one-peer-expo"), []),
        (graphs.b_connected_ring_schedule(m, b=7, seed=1), []),
        (graphs.random_b_connected_schedule(
            m, b=4, p_keep=0.4, seed=np.random.default_rng(2)), []),
        (ring, [scenarios.LinkFailures(0.3)]),
        (ring, [scenarios.NodeChurn(0.2, dwell=10)]),
        (ring, [scenarios.LinkFailures(0.3), scenarios.NodeChurn(0.1)]),
    ]

    hp = dpsvrg.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4,
                                  num_outer=args.num_outer)
    rows = []
    print("schedule                                spectral-gap(W̄)   gap      consensus")
    for base, models in cases:
        sched, backend = scenarios.apply(base, models, seed=7)
        algo = algorithm.ALGORITHMS["dpsvrg"](problem, hp)
        hist = runner.run(algo, problem, sched, ExecSpec(
            gossip=backend if models else "auto", device=args.device),
            record_every=0).history
        # the UNDEGRADED period-average gap; degraded realizations mix slower
        wbar = base.phi(0, base.period - 1)
        rows.append((sched.name, hist))
        print(f"{sched.name:36s}    {graphs.spectral_gap(wbar):8.4f}      "
              f"{hist.objective[-1]:.5f}  {hist.consensus[-1]:.2e}")
    print("\nLemma 1 in action: denser/better-mixing schedules reach tighter "
          "consensus at equal steps; seeded link failures and node churn "
          "slow consensus but b-connected-in-expectation schedules still "
          "converge.")

    # transport-level degradation: payloads arrive 2 slots stale and half
    # the nodes are 2x-slowed stragglers — the delay buffer threads through
    # the algorithm's mix state, so the run stays on the resident path
    sched, backend = scenarios.apply(
        ring, [scenarios.StaleGossip(2), scenarios.Stragglers(2.0)], seed=7)
    algo = algorithm.ALGORITHMS["loopless_dpsvrg"](
        problem, 0.2, args.steps, snapshot_prob=0.05)
    res = runner.run(algo, problem, sched, ExecSpec(
        resident=True, gossip=backend, device=args.device),
        record_every=max(1, args.steps // 4))
    hist = res.history
    rows.append(("stale+straggler", hist))
    print(f"stale+straggler gossip (resident): F={hist.objective[-1]:.5f} "
          f"consensus={hist.consensus[-1]:.2e} "
          f"wire={np.asarray(res.extras['wire_bytes'])[-1] / 1e3:.0f}kB")

    # the TDMA matchings have degree <= 2: the same run gossips in O(degree)
    # banded passes with a float-tolerance-equal history — gossip="auto"
    # detects the band structure and selects the banded transport; the
    # resident path replays CUDA graphs of its pieces on the card; the
    # wire_bytes extras column reports the bytes moved
    hp = dpsvrg.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4,
                                  num_outer=args.num_outer, k_max=2)
    algo = algorithm.ALGORITHMS["dpsvrg"](problem, hp)
    res = runner.run(algo, problem, tdma, ExecSpec(
        resident=True, gossip="auto", device=args.device), record_every=0)
    hist = res.history
    rows.append(("tdma-banded", hist))
    print(f"banded-gossip resident on tdma-matchings: "
          f"F={hist.objective[-1]:.5f} "
          f"consensus={hist.consensus[-1]:.2e} "
          f"wire={res.extras['wire_bytes'][-1] / 1e3:.0f}kB")
    return rows


if __name__ == "__main__":
    main()
