"""DPSVRG (arXiv:2112.10389, Algorithm 1) on l1-regularized logistic
regression (Eq. 26), every cell of a grid at once, in plain PyTorch.

Per node i, inner step k of outer round s:

    v_i  = grad_B f_i(x_i) - grad_B f_i(x~_i) + grad f_i(x~_i)
    x_i <- prox_{alpha h}( sum_j (W^k)_ij (x_j - alpha v_j) )

with k gossip rounds at step k (multi-consensus), K_s = ceil(beta^s n0)
steps in round s, the snapshot x~ the average of round s-1's iterates,
and h = lam ||.||_1.  Each cell draws its minibatch indices from
``np.random.default_rng(seed)``, (m, batch) integers a step, in the order
of the steps: the paper's uniform sampling, made reproducible.  The
objective F(x_bar) = mean_i f_i(x_bar) + h(x_bar), the consensus
distance mean_i ||x_i - x_bar|| and ||x_bar|| are recorded at the start
and after every round."""

from __future__ import annotations

import math

import numpy as np
import torch

from .numerics import Precision, no_tf32


def ring_matrix(m: int) -> np.ndarray:
    """The ring's Metropolis weights: a third to each neighbour and to
    itself (b = 1: the same matrix at every slot)."""
    w = np.eye(m) / 3.0
    for i in range(m):
        w[i, (i + 1) % m] += 1.0 / 3.0
        w[i, (i - 1) % m] += 1.0 / 3.0
    return w


def inner_lengths(beta: float, n0: int, rounds: int) -> list:
    return [int(math.ceil(beta ** s * n0)) for s in range(1, rounds + 1)]


def run(features, labels, lams, seeds, *, alpha: float, beta: float,
        n0: int, num_outer: int, batch: int, dtype=torch.float64,
        precision: str = "exact") -> dict:
    """features (m, n, d), labels (m, n) on one device; ``lams`` and
    ``seeds`` one a cell.  -> {"objective": (R, B), "consensus": (R, B),
    "xbar_norm": (R, B), "params": (B, m, d)} as float64 numpy / the last
    a tensor."""
    no_tf32()
    p = Precision(precision)
    A = features.to(dtype)
    y = labels.to(dtype)
    m, n, d = A.shape
    B = len(seeds)
    dev = A.device
    lam = torch.as_tensor(np.asarray(lams, np.float64), dtype=dtype,
                          device=dev)[:, None, None]
    w1 = ring_matrix(m)
    powers = {}

    def mix(k: int):
        if k not in powers:
            out = np.eye(m)
            for _ in range(k):
                out = w1 @ out
            powers[k] = torch.as_tensor(out, dtype=dtype, device=dev)
        return powers[k]

    def full_grad(w):                        # (B, m, d) -> (B, m, d)
        z = p.einsum("mnd,bmd->bmn", A, w)
        r = torch.sigmoid(z) - y[None]
        return p.einsum("bmn,mnd->bmd", r, A) / n

    def batch_grad(w, rows, ys):             # rows (B, m, k, d)
        z = p.einsum("bmkd,bmd->bmk", rows, w)
        r = torch.sigmoid(z) - ys
        return p.einsum("bmk,bmkd->bmd", r, rows) / rows.shape[2]

    objective, consensus, scale = [], [], []

    def record(x):
        xbar = x.mean(dim=1)                             # (B, d)
        z = p.einsum("mnd,bd->bmn", A, xbar)
        loss = (-y[None] * z + torch.log1p(torch.exp(z))).mean(dim=(1, 2))
        objective.append((loss + lam[:, 0, 0] * xbar.abs().sum(-1)).cpu())
        consensus.append(torch.linalg.vector_norm(
            x - xbar[:, None], dim=-1).mean(dim=1).cpu())
        scale.append(torch.linalg.vector_norm(xbar, dim=-1).cpu())

    rngs = [np.random.default_rng(s) for s in seeds]
    x = torch.zeros((B, m, d), dtype=dtype, device=dev)
    anchor = torch.zeros_like(x)
    node = torch.arange(m, device=dev)[None, :, None]
    thresh = alpha * lam
    record(x)
    for K in inner_lengths(beta, n0, num_outer):
        snap = anchor
        mu = full_grad(anchor)
        acc = torch.zeros_like(x)
        for k in range(1, K + 1):
            idx = torch.as_tensor(np.stack(
                [r.integers(0, n, size=(m, batch)) for r in rngs]),
                device=dev)
            rows, ys = A[node, idx], y[node, idx]
            v = batch_grad(x, rows, ys) - batch_grad(snap, rows, ys) + mu
            q = p.einsum("ij,bjd->bid", mix(k), x - alpha * v)
            x = torch.sign(q) * torch.clamp_min(q.abs() - thresh, 0.0)
            acc = acc + x
        anchor = acc / K
        record(x)
    return {"objective": torch.stack(objective).double().numpy(),
            "consensus": torch.stack(consensus).double().numpy(),
            "xbar_norm": torch.stack(scale).double().numpy(),
            "params": x}
