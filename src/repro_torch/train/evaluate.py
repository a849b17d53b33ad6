"""Held-out evaluation: perplexity / bits-per-token over a token stream.
The port of ``repro.train.evaluate``.

Evaluates the NODE-AVERAGED model (x-bar), the quantity the paper's theory
bounds, and optionally each node's copy, whose spread is another view of
consensus quality.  The windows are drawn from ``np.random.default_rng
(seed)`` as the reference draws them."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import gossip
from ..models import transformer
from ..models.api import ModelConfig

__all__ = ["evaluate_lm", "evaluate_stacked"]


def evaluate_lm(cfg: ModelConfig, params, tokens: np.ndarray,
                batch: int = 8, seq_len: int = 128,
                max_batches: int = 8, seed: int = 0) -> dict:
    """Perplexity of a single model over a held-out token array, on the
    parameters' device."""
    loss_fn = transformer.loss_fn(cfg)
    device = pytree.tree_leaves(params)[0].device
    rng = np.random.default_rng(seed)
    hi = len(tokens) - seq_len - 1
    losses = []
    with torch.no_grad():
        for _ in range(max_batches):
            starts = rng.integers(0, hi, size=batch)
            toks = np.stack([tokens[s:s + seq_len]
                             for s in starts]).astype(np.int32)
            labs = np.stack([tokens[s + 1:s + seq_len + 1]
                             for s in starts]).astype(np.int32)
            losses.append(float(loss_fn(params, {
                "tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labs).to(device)})))
    nll = float(np.mean(losses))
    return {"nll": nll, "ppl": math.exp(min(nll, 30.0)),
            "bits_per_token": nll / math.log(2.0)}


def evaluate_stacked(cfg: ModelConfig, stacked_params, tokens: np.ndarray,
                     **kw) -> dict:
    """Evaluate the node average + per-node spread of a stacked model."""
    xbar = gossip.node_mean(stacked_params)
    center = evaluate_lm(cfg, xbar, tokens, **kw)
    m = pytree.tree_leaves(stacked_params)[0].shape[0]
    per_node = [evaluate_lm(cfg, gossip.unstack_tree(stacked_params, i),
                            tokens, **kw)["nll"] for i in range(m)]
    center["node_nll_mean"] = float(np.mean(per_node))
    center["node_nll_std"] = float(np.std(per_node))
    return center
