"""Shared harness of the PyTorch port's benchmarks (``benchmarks/pt_*.py``).

The port of ``benchmarks/common.py`` (and of what ``benchmarks/
runner_bench.py`` gives the kernel bench): the ``Row`` record, the paper's
Eq. 26 logistic loss in torch, ``setup_problem`` (one of the four Table I
datasets at a scale, partitioned over m nodes, on a device), ``f_star``
(F(x*) by centralized proximal gradient, on the data's device),
``run_algorithm`` and ``run_sweep`` (the figure drivers' one calling
convention, the reference's signatures plus ``device`` and ``kernel``),
``Sweep`` (one figure sweep, so that ``chip_smoke.py`` runs the figures'
own grids in every mode), ``_time_run`` (best-of-N wall time of a whole
``runner.run``) and ``float64_models`` (the port's models evaluated in
float64, the yardstick of an ill-conditioned float32 run).  Nothing here imports JAX or the JAX package, so the
``benchmarks/pt_*.py`` drivers run where only PyTorch is installed.

Every entry point runs on the CUDA device unless it is asked for the CPU;
without a card it raises instead of measuring the CPU under a card's name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (algorithm, dpsvrg, gossip, prox,  # noqa: E402
                              runner, sweep)
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

__all__ = ["Row", "logreg_loss", "require_device", "setup_problem",
           "make_problem", "run_algorithm", "run_sweep", "Sweep", "f_star",
           "timed", "sync", "_time_run", "float64_models"]


@dataclasses.dataclass
class Row:
    """One bench row: ``name,us_per_call,derived`` as the reference's CSV,
    plus ``data``, the row's numbers as a dict (kernel calls made, errors,
    the resident sections) for callers that check them."""
    name: str
    us_per_call: float
    derived: str
    data: dict = dataclasses.field(default_factory=dict)


def logreg_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))  # Eq. 26


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port's benchmarks run on the CUDA device by default and "
            "none is available; pass --device cpu to run them on the CPU")
    return device


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup_problem(dataset: str, scale: float, m: int = 8, lam: float = 0.01,
                  seed: int = 0, device="cuda"):
    """-> (data, flat, h, x0, d): ``dataset`` at ``scale`` partitioned over
    m nodes as tensors on ``device``, the node-flattened data, the l1 prox,
    the stacked zero start point (contiguous) and the feature dimension."""
    device = require_device(device)
    ds = synthetic.make_paper_dataset(dataset, scale=scale, seed=seed)
    data = params_from_numpy(synthetic.partition_per_node(ds, m, seed=seed),
                             device)
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
    h = prox.l1(lam)
    d = ds.dim
    x0 = gossip.stack_tree(torch.zeros(d, device=device), m).contiguous()
    return data, flat, h, x0, d


def make_problem(data, h, x0, objective_fn=None) -> algorithm.Problem:
    return algorithm.Problem(logreg_loss, h, x0, data, objective_fn)


def _spec(*, resident, sampling="host", gossip="dense", device="cuda",
          kernel="plain", scan=False) -> ExecSpec:
    """The figures' ExecSpec: ``kernel`` applies to resident runs only (the
    host loop has no fused step)."""
    return ExecSpec(scan=scan, resident=resident, sampling=sampling,
                    gossip=gossip, device=device,
                    kernel=kernel if resident else "plain")


def run_algorithm(name: str, problem, sched, *factory_args, seed=0,
                  record_every=1, scan=False, resident=False,
                  sampling="host", gossip="dense", device="cuda",
                  kernel="plain", **factory_kw) -> runner.RunResult:
    """Build ``ALGORITHMS[name]`` and drive it through ``runner.run`` — the
    one calling convention every figure script shares.  ``gossip`` pins the
    dense wire format, as the reference's figures do; ``device`` is where
    the problem's tensors lie; ``kernel`` picks the resident step."""
    algo = algorithm.ALGORITHMS[name](problem, *factory_args, **factory_kw)
    return runner.run(algo, problem, sched,
                      _spec(scan=scan, resident=resident, sampling=sampling,
                            gossip=gossip, device=device, kernel=kernel),
                      seed=seed, record_every=record_every)


def run_sweep(build, grid, sched=None, *, seed=0, record_every=1,
              resident=False, sweep_batched=False, mode="product",
              gossip="dense", device="cuda",
              kernel="plain") -> sweep.SweepResult:
    """Drive a figure's grid through ``core.sweep.run_sweep``.  Default
    (``resident=False, sweep_batched=False``): the cells one after another
    on the host loop; ``resident=True``: sequential resident cells;
    ``sweep_batched=True``: the WHOLE grid as one batched resident run (one
    staging step and one history pull for the figure)."""
    return sweep.run_sweep(
        build, grid, sched,
        _spec(resident=resident or sweep_batched, gossip=gossip,
              device=device, kernel=kernel),
        seed=seed, record_every=record_every, batched=sweep_batched,
        mode=mode)


@dataclasses.dataclass
class Sweep:
    """One figure sweep as ``run_sweep`` takes it: a cell factory over a
    grid, its schedule (None for a ``"schedule"`` axis), cadence and grid
    mode.  ``run(**kw)`` passes the execution keywords of ``run_sweep``."""
    build: Callable
    grid: dict
    sched: Any = None
    record_every: int = 1
    mode: str = "product"

    def run(self, **kw) -> sweep.SweepResult:
        return run_sweep(self.build, self.grid, self.sched,
                         record_every=self.record_every, mode=self.mode, **kw)


def f_star(flat, h, d, alpha=0.4, steps=4000) -> float:
    """F(x*) for the optimality gap (paper Section V-B): the least
    objective of centralized full-batch proximal gradient, on the device
    the node-flattened data lie on."""
    device = next(iter(flat.values())).device
    _, hist = dpsvrg.centralized_prox_gd(logreg_loss, h,
                                         torch.zeros(d, device=device), flat,
                                         alpha, steps)
    return float(np.min(hist))


def timed(fn, device="cuda"):
    """(fn(), its wall time in us, ended by a device synchronize)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e6


def _time_run(algo, problem, sched, *, record_every, iters=3, **kw) -> float:
    """Best-of-``iters`` wall time of ``runner.run`` in us, after one warm-up
    run; ``kw`` are the ``ExecSpec`` fields.  The minimum is the figure that
    repeats, since scheduler noise only ever adds time."""
    spec = ExecSpec(**kw)
    runner.run(algo, problem, sched, spec, seed=0, record_every=record_every)
    sync(spec.device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        runner.run(algo, problem, sched, spec, seed=0,
                   record_every=record_every)
        sync(spec.device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


@contextlib.contextmanager
def float64_models():
    """Within the block the port's models keep float64 where they cast to
    float32 otherwise: the SSM states (``ssm.F32``), the plain RMSNorm and
    the loss's logits.  With float64 parameters and
    ``logit_dtype="float64"`` a model then runs, and trains, in float64:
    the yardstick of its float32 runs where those are ill-conditioned
    (xlstm-350m's mLSTM normalizer max(|n.q|, exp(-m)) has poles)."""
    from repro_torch.models import common, ssm, transformer
    saved = (ssm.F32, common.rms_norm, transformer.loss_fn)

    def rms_norm(x, weight, eps=1e-6):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * (1.0 + weight)

    def loss_fn(cfg):
        def fn(params, batch):
            logits, aux = transformer.forward(cfg, params, batch["tokens"])
            labels = batch["labels"].to(torch.int64)
            correct = torch.gather(logits, -1, labels[..., None])[..., 0]
            loss = torch.mean(torch.logsumexp(logits, dim=-1) - correct)
            if cfg.moe_period > 0:
                loss = loss + cfg.moe_aux_weight * aux / cfg.num_layers
            return loss
        return fn

    ssm.F32, common.rms_norm = torch.float64, rms_norm
    transformer.loss_fn = loss_fn
    try:
        yield
    finally:
        ssm.F32, common.rms_norm, transformer.loss_fn = saved
