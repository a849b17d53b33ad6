"""A grid of the paper's DPSVRG runs as one batched resident sweep
(``core.sweep.run_sweep``), whole grids back to back.

Traffic parameters: ``lams`` (the grid's l1 weights), ``seeds_per_lam``
(each cell's sampling stream, drawn from the run's seed), ``record_every``
(0: a record at the end of every outer round), ``trace_grids`` (grids in a
traced window) and ``limits``.

One epoch is m * n_i component gradients: a refresh is one, and an inner
step 2 m * batch of them.  ``logreg_epochs_per_s`` sums the window's
grids' epochs over its wall time; the window ends with the first grid to
finish after ``--seconds``.  One grid of the window, drawn from the seed,
is held against the reference: every cell's objective and consensus
history and final parameters."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..frozen import counts
from ..harness import Outcome
from . import datasets


def logreg_loss(w, batch):
    """Eq. 26 on a minibatch: mean of -y a.w + log(1 + exp(a.w))."""
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))


def cell_seeds(seed: int, k: int) -> list:
    return [int(s) for s in np.random.default_rng([seed, 0x6C]).integers(
        0, 2**31 - 1, size=k)]


def epochs_per_cell(cfg: dict) -> float:
    """Epochs of one run: a refresh a round, 2 m batch gradients a step."""
    m, n_i = cfg["m"], cfg["dataset"]["n"] // cfg["m"]
    steps = sum(_lengths(cfg))
    return cfg["num_outer"] + steps * 2 * m * cfg["batch_size"] / (m * n_i)


def _lengths(cfg: dict) -> list:
    from reference.logreg_dpsvrg import inner_lengths
    return inner_lengths(cfg["beta"], cfg["n0"], cfg["num_outer"])


def run(r) -> Outcome:
    from repro_torch.core import algorithm, gossip, graphs, prox, sweep
    from repro_torch.core.exec_spec import ExecSpec

    cfg, mix = r.config, r.traffic
    m, bsz = cfg["m"], cfg["batch_size"]
    data = datasets.classification(cfg["dataset"], m, r.seed, r.device)
    n_i, d = data["features"].shape[1:]
    x0 = gossip.stack_tree(torch.zeros(d, device=r.device), m).contiguous()
    hp = algorithm.DPSVRGHyperParams(alpha=cfg["alpha"], beta=cfg["beta"],
                                     n0=cfg["n0"], num_outer=cfg["num_outer"],
                                     batch_size=bsz)

    def build(lam=cfg["lam"]):
        problem = algorithm.Problem(logreg_loss, prox.l1(lam), x0, data)
        return algorithm.ALGORITHMS["dpsvrg"](problem, hp), problem

    lams = list(mix["lams"])
    seeds = cell_seeds(r.seed, mix["seeds_per_lam"])
    grid = {"lam": lams, "seed": seeds}
    sched = graphs.b_connected_ring_schedule(m, b=cfg["topology"]["b"])
    spec = ExecSpec(resident=True, kernel=cfg["kernel"], gossip=cfg["gossip"],
                    device=r.device)

    def one_grid():
        with r.span("bench.grid"):
            res = sweep.run_sweep(build, grid, sched, spec,
                                  record_every=mix["record_every"])
        return res

    one_grid()                                  # warm-up: every shape
    r.setup_done()

    results, times = [], []
    tracer = None
    if r.trace:
        from ..trace import Tracer
        tracer = Tracer(r.device)
        tracer.__enter__()
    t0 = time.perf_counter()
    while True:
        res = one_grid()                        # ends in its history pull
        results.append(res)
        times.append(time.perf_counter())
        if r.trace and len(results) >= mix["trace_grids"]:
            break
        if not r.trace and times[-1] - t0 >= r.seconds:
            break
    if tracer is not None:
        tracer.__exit__(None, None, None)
    wall = times[-1] - t0
    peak = r.memory_peak()

    B = len(lams) * len(seeds)
    per_cell = epochs_per_cell(cfg)
    epochs_ok = all(np.allclose(np.asarray(g.history.epochs)[-1], per_cell,
                                rtol=1e-9, atol=0) for g in results)
    least = counts.logreg_grid(
        B, m, n_i, d, bsz, _lengths(cfg), len(results[0].history.objective))
    counters = {"replays": float(np.mean([g.extras["replays"]
                                          for g in results]))}
    work = {"units": len(results), "least_s": least * len(results),
            "fused_step_bytes": counts.fused_step_bytes(B, m, d),
            "unit_s": list(np.diff([t0] + times))}

    # the reference: one grid of the window, drawn from the seed
    pick = int(np.random.default_rng([r.seed, 0x70]).integers(len(results)))
    got = results[pick]
    obj = np.asarray(got.history.objective)
    cons = np.asarray(got.history.consensus)
    params = got.params.detach()
    del results
    from reference import logreg_dpsvrg
    cells = [(lam, s) for lam in lams for s in seeds]

    def reference(**kw):
        return logreg_dpsvrg.run(
            data["features"], data["labels"], [c[0] for c in cells],
            [c[1] for c in cells], alpha=cfg["alpha"], beta=cfg["beta"],
            n0=cfg["n0"], num_outer=cfg["num_outer"], batch=bsz, **kw)

    ref = reference(dtype=torch.float64)
    checks = r.checks()
    compare(checks, obj, cons, params, ref)
    checks.add("epochs_mismatch", 0.0 if epochs_ok else 1.0)
    controls = {}
    for name in mix.get("controls", ()):
        ctl = reference(dtype=torch.float32, precision=name)
        c = r.checks()
        compare(c, ctl["objective"], ctl["consensus"], ctl["params"], ref)
        controls[name] = c.as_dict()
    return Outcome(
        e2e={"logreg_epochs_per_s": per_cell * B * len(times) / wall},
        attempted=B * len(times), failed=0, checks=checks, work=work,
        counters=counters, memory_peak_bytes=peak,
        trace=None if tracer is None else tracer.result, controls=controls)


def compare(checks, obj, cons, params, ref) -> None:
    """Every cell's objective and consensus history, each over the largest
    magnitude of the cell's reference history, and its final parameters
    over their largest magnitude: the worst cell of each."""
    checks.add("objective_gap", _gap(obj, ref["objective"], axis=0))
    # the nodes nearly agree, so the consensus distance is a difference of
    # near-equal iterates: its error is held against the iterates' scale
    checks.add("consensus_gap", _gap(cons, ref["consensus"], axis=0,
                                     scale=ref["xbar_norm"]))
    want = ref["params"].double()
    scale = want.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    got = params.double()
    checks.add("params_gap", float(((got - want).abs().amax(dim=(1, 2))
                                    / scale).max()) if got.shape == want.shape
               else float("inf"))


def _gap(got, want, axis: int, scale=None) -> float:
    """The worst gap over cells of a history column, each cell's gap over
    the largest magnitude of its reference history (or of ``scale``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    scale = np.maximum(np.abs(want if scale is None else scale).max(
        axis=axis), 1e-30)
    return float((np.abs(got - want).max(axis=axis) / scale).max())
