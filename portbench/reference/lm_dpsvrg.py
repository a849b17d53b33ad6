"""DPSVRG training of the dense LM over m nodes (arXiv:2112.10389,
Algorithm 1, with the LM's large-batch refresh standing in for the full
local gradient), in plain PyTorch, one node at a time.

Round 0 from the common start w0, for node i:

    snapshot_i = x_i,   mu_i = grad f_i(x_i; refresh batch_i)
    step t:   v_i = grad f_i(x_i; B_i^t) - grad f_i(snapshot_i; B_i^t) + mu_i
              x_i <- prox_{alpha lam |.|_1}( sum_j W_ij (x_j - alpha v_j) )

where W is the ring's consensus product the configuration states, a
window of ``seq + 1`` tokens at start s of node i's shard gives the tokens
s..s+seq-1 and the labels s+1..s+seq, and f_i is the mean next-token
cross-entropy over the batch.  Returned: each step's mean loss over the
nodes and the norm of the whole update direction v, and by leaf and node
the norm of mu and of x - w0 after the steps.

The minibatches are those of the program's data loader, worked out again
here (``loader_starts``): node i's shard is its contiguous m-th of the
stream, and one generator seeded with the run's seed draws, for each step,
a refresh's starts when the step refreshes and then the minibatch's, node
by node.

``fault`` plants a fault for the readings that set a limit's upper end:
``"half_batch"`` takes each batch's mean over its first half of windows
(a batch of one window a node stays whole),
``"no_mix"`` leaves the exchange between nodes out (W = I)."""

from __future__ import annotations

import numpy as np
import torch

from . import dense_lm
from .numerics import Precision


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _rebuild(tree, values):
    it = iter(values)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return [go(v) for v in t]

    return go(tree)


def loader_starts(seed: int, m: int, B: int, mult: int, steps: int,
                  n: int):
    """The window starts (in [0, n)) of a run's first ``steps`` steps, the
    first a refresh: -> (refresh (m, B * mult), steps' (steps, m, B))."""
    rng = np.random.default_rng(seed)

    def draw(size):
        return np.stack([rng.integers(0, n, size=size) for _ in range(m)])

    big = draw(B * mult)
    return big, np.stack([draw(B) for _ in range(steps)])


def _windows(shard, starts, seq):
    idx = torch.as_tensor(starts, device=shard.device)[:, None] \
        + torch.arange(seq + 1, device=shard.device)
    win = shard[idx]
    return win[:, :-1], win[:, 1:]


def _grad(tree, cfg, tokens, labels, prec, chunk):
    """(mean loss, gradient leaves) over the windows, ``chunk`` at a time
    (equal chunks: the mean of their means)."""
    names = _leaves(tree)
    total_loss, total = 0.0, None
    n = tokens.shape[0] // chunk
    for c in range(n):
        ps = [t.detach().requires_grad_(True) for _, t in names]
        loss = dense_lm.loss(_rebuild(tree, ps), cfg,
                             tokens[c * chunk:(c + 1) * chunk],
                             labels[c * chunk:(c + 1) * chunk], prec)
        gs = torch.autograd.grad(loss, ps)
        total_loss += float(loss.detach()) / n
        total = [g / n for g in gs] if total is None else [
            a + g / n for a, g in zip(total, gs)]
    return total_loss, total


def run(model: dict, mix: dict, w0, shards, starts, W, *, steps: int,
        precision: str = "exact", fault: str | None = None) -> dict:
    prec = Precision(precision)
    m, B, L = mix["m"], mix["per_node_batch"], mix["seq"]
    alpha, thresh = mix["alpha"], mix["alpha"] * mix["lam"]
    big, st = starts
    names = [n for n, _ in _leaves(w0)]
    w0_leaves = [t for _, t in _leaves(w0)]
    if fault == "no_mix":
        W = [[1.0 if i == j else 0.0 for j in range(m)] for i in range(m)]
    keep = (lambda n: max(n // 2, 1)) if fault == "half_batch" \
        else (lambda n: n)

    x = [[t.clone() for t in w0_leaves] for _ in range(m)]
    mu, snap = [], []
    for i in range(m):
        tok, lab = _windows(shards[i], big[i][:keep(len(big[i]))], L)
        _, g = _grad(w0, model, tok, lab, prec, keep(B))
        mu.append(g)
        snap.append(x[i])
    losses, v_norms = [], []
    for t in range(steps):
        q, loss_t, vsq = [], 0.0, 0.0
        for i in range(m):
            tok, lab = _windows(shards[i], st[t][i][:keep(B)], L)
            tree_x = _rebuild(w0, x[i])
            li, g_now = _grad(tree_x, model, tok, lab, prec, keep(B))
            _, g_snap = _grad(_rebuild(w0, snap[i]), model, tok, lab, prec,
                              keep(B))
            v = [a - b + c for a, b, c in zip(g_now, g_snap, mu[i])]
            del g_now, g_snap
            vsq += sum(float(torch.sum(vi.double() ** 2)) for vi in v)
            q.append([xi - alpha * vi for xi, vi in zip(x[i], v)])
            loss_t += li / m
            del v
        new = []
        for i in range(m):
            leaves = []
            for k in range(len(names)):
                z = sum(float(W[i][j]) * q[j][k] for j in range(m))
                leaves.append(torch.sign(z) * torch.clamp_min(
                    z.abs() - thresh, 0.0))
            new.append(leaves)
        del q
        x = new
        losses.append(loss_t)
        v_norms.append(vsq ** 0.5)
    grad = {f"{n}[{i}]": float(torch.linalg.vector_norm(mu[i][k].double()))
            for i in range(m) for k, n in enumerate(names)}
    change = {f"{n}[{i}]": float(torch.linalg.vector_norm(
        (x[i][k] - w0_leaves[k]).double()))
        for i in range(m) for k, n in enumerate(names)}
    return {"loss": losses, "v_norm": v_norms, "grad": grad,
            "change": change}
