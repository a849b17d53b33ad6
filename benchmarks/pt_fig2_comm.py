"""Fig. 2: optimality gap vs. cumulative communication rounds.  The port of
``benchmarks/fig2_comm.py``: the same runs, budget and derived columns.

Paper claim: despite multi-consensus costing k gossip rounds at inner step
k, DPSVRG reaches the optimum with LESS total communication than DSPG.
Beyond the paper, the transports' byte accounting reports the
communication in wire bytes, as run totals and per directed link."""

from __future__ import annotations

import numpy as np

from . import pt_common as common
from repro_torch.core import algorithm, dpsvrg, graphs, transport


def _rounds_stream(meta, steps: int) -> list:
    """The in-run order of gossip ``rounds`` values, as the runner consumes
    schedule slots: keyed by the in-round step for outer/inner methods and
    by the global step for flat loops."""
    out: list = []
    if meta.outer_lengths is not None:
        for K in meta.outer_lengths:
            for k in range(1, K + 1):
                out.append(meta.gossip_rounds(k))
                if len(out) == steps:
                    return out
        return out
    return [meta.gossip_rounds(t) for t in range(1, steps + 1)]


def per_link_totals(backend_name: str, sched, meta, x0, steps: int) -> dict:
    """Replay ``steps`` inner steps through a backend's per-link accounting
    and return cumulative ``{(src, dst): bytes}``."""
    backend = transport.GOSSIP_BACKENDS[backend_name]
    aux = backend.prepare(sched, meta)
    pc = transport.node_param_count(x0)
    totals: dict = {}
    slot = 0
    for rounds in _rounds_stream(meta, steps):
        phi = backend.phi_for(aux, slot, rounds)
        for link, b in backend.bytes_per_link(aux, phi, pc).items():
            totals[link] = totals.get(link, 0) + b
        slot += rounds
    return totals


def run(scale: float = 0.02, alpha: float = 0.2, resident: bool = False,
        device="cuda", kernel="plain"):
    rows = []
    data, flat, h, x0, d = common.setup_problem("mnist_like", scale,
                                                device=device)
    fs = common.f_star(flat, h, d)
    sched = graphs.b_connected_ring_schedule(8, b=1)
    problem = common.make_problem(data, h, x0)
    hp = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4, num_outer=10)
    kw = dict(resident=resident, device=device, kernel=kernel)
    rv = common.run_algorithm("dpsvrg", problem, sched, hp, record_every=4,
                              **kw)
    hv = rv.history
    comm_vr = int(hv.comm_rounds[-1])
    # give DSPG the SAME total communication budget
    rd = common.run_algorithm("dspg", problem, sched,
                              dpsvrg.DSPGHyperParams(alpha0=alpha),
                              comm_vr, record_every=16, **kw)
    hd = rd.history
    gap_vr = hv.objective[-1] - fs
    gap_ds = hd.objective[-1] - fs
    # gap at matched communication points (quartiles of the budget)
    marks = [comm_vr // 4, comm_vr // 2, comm_vr]
    matched = []
    for mk in marks:
        gv = hv.objective[np.searchsorted(hv.comm_rounds, mk).clip(
            0, len(hv.objective) - 1)] - fs
        gd = hd.objective[np.searchsorted(hd.comm_rounds, mk).clip(
            0, len(hd.objective) - 1)] - fs
        matched.append((mk, gv, gd))
    rows.append(common.Row(
        "fig2/mnist_like/comm_budget", 0.0,
        f"rounds={comm_vr} gap_dpsvrg={gap_vr:.5f} gap_dspg={gap_ds:.5f} "
        + " ".join(f"@{mk}:({gv:.4f}|{gd:.4f})" for mk, gv, gd in matched)))
    rows.append(common.Row(
        "fig2/mnist_like/wire_bytes", 0.0,
        f"dpsvrg={int(rv.extras['wire_bytes'][-1])} "
        f"dspg={int(rd.extras['wire_bytes'][-1])} at matched round budget"))
    # per-link byte maps on the k_max-capped run (banded structure present)
    capped = dpsvrg.DPSVRGHyperParams(alpha=alpha, beta=1.2, n0=4,
                                      num_outer=10, k_max=2)
    meta = algorithm.ALGORITHMS["dpsvrg"](problem, capped).meta
    match = graphs.MixingSchedule(
        tuple(graphs.edge_matching_matrices(8)), b=2, eta=0.5,
        name="tdma-matching8")
    steps = int(hv.steps[-1])
    for name in ("dense", "banded"):
        links = per_link_totals(name, match, meta, x0, steps)
        per_edge = np.array(sorted(links.values()))
        rows.append(common.Row(
            f"fig2/per_link/{name}", 0.0,
            f"links={len(links)} total={per_edge.sum()} "
            f"max_edge={per_edge[-1]} min_edge={per_edge[0]} "
            f"(topology-aware: "
            f"{'ring links only' if name == 'banded' else 'all-to-all'})"))
    return rows
