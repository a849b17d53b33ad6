"""Shared harness of the PyTorch port's benchmarks (``benchmarks/pt_*.py``).

The port of what ``benchmarks/common.py`` and ``benchmarks/runner_bench.py``
give the kernel bench: the ``Row`` record, the paper's Eq. 26 logistic loss
in torch, ``setup_problem`` (a Table-I-shaped dataset partitioned over m
nodes, on a device) and ``_time_run`` (best-of-N wall time of a whole
``runner.run``).  Nothing here imports JAX or the JAX package, so
``python -m benchmarks.pt_kernel_bench`` runs where only PyTorch is
installed.

Every entry point runs on the CUDA device unless it is asked for the CPU;
without a card it raises instead of measuring the CPU under a card's name.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import gossip, prox, runner  # noqa: E402
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

__all__ = ["Row", "logreg_loss", "require_device", "setup_problem",
           "sync", "_time_run"]


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
