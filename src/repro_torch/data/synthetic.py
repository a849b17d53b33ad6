"""Synthetic datasets.

Two families:

* Classification datasets with the geometry of the paper's Table I
  (MNIST-like, CIFAR-like, Adult-like, Covtype-like) for the faithful
  DPSVRG-vs-DSPG reproduction — binary labels {0,1}, Gaussian class
  clusters, controllable inter-node heterogeneity (non-IID partitions make
  decentralized variance reduction matter more).
* Token streams for LM training (Zipfian unigram + Markov bigram structure so
  that a real model actually reduces loss on it).

Everything is deterministic in the seed and partitioned per node.

A copy of ``repro.data.synthetic`` (numpy only), kept in the port so that it never
imports JAX; the parity tests hold the two bitwise equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ClassificationDataset", "make_classification", "PAPER_DATASETS",
           "make_paper_dataset", "partition_per_node", "TokenStream",
           "make_token_stream"]


@dataclasses.dataclass(frozen=True)
class ClassificationDataset:
    """features: (N, d) float32 in [-1, 1]-ish; labels: (N,) float32 {0,1}."""
    name: str
    features: np.ndarray
    labels: np.ndarray

    @property
    def n(self) -> int:
        return self.features.shape[0]

    @property
    def dim(self) -> int:
        return self.features.shape[1]


# Geometry of the paper's Table I (train size scaled down by `scale` for CI).
PAPER_DATASETS = {
    "mnist_like": dict(n=60_000, d=784),
    "cifar10_like": dict(n=50_000, d=1024),
    "adult_like": dict(n=30_161, d=30),
    "covertype_like": dict(n=100_000, d=54),
}


def make_classification(n: int, d: int, seed: int = 0, margin: float = 1.0,
                        noise: float = 0.4, sparsity: float = 0.5,
                        row_norm: float = 1.0,
                        name: str = "synthetic") -> ClassificationDataset:
    """Binary classification with a sparse ground-truth separator.

    A sparse true weight vector makes the l1-regularized optimum meaningful
    (the paper's setting rewards prox-induced sparsity).  ``row_norm``
    controls the smoothness constant (L = row_norm^2 / 4 for logistic) and
    the per-coordinate gradient scale relative to the l1 threshold — high-d
    datasets need row_norm > 1 or the l1 prox kills every coordinate.
    """
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    mask = rng.random(d) < sparsity
    w_true = w_true * np.maximum(mask, 1e-12)
    x = rng.normal(size=(n, d))
    # normalize rows to a fixed norm like preprocessed image data -> bounds
    # L = max ||a_i a_i^T|| (the paper's smoothness example)
    x *= row_norm / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    raw = x @ w_true
    raw *= margin * 3.0 / max(np.std(raw), 1e-9)   # decisive but not separable
    logits = raw + noise * rng.normal(size=n)
    y = (logits > 0).astype(np.float32)
    return ClassificationDataset(name=name, features=x.astype(np.float32), labels=y)


def make_paper_dataset(key: str, scale: float = 1.0, seed: int = 0) -> ClassificationDataset:
    spec = PAPER_DATASETS[key]
    n = max(int(spec["n"] * scale), 64)
    # row_norm 3 (L ~ 2.25) + a sparse teacher (16 active coordinates) keep
    # the per-coordinate gradient above the l1 threshold, so the regularized
    # optimum is sparse-but-nonzero like the paper's real datasets
    return make_classification(n=n, d=spec["d"], seed=seed, name=key,
                               row_norm=3.0, noise=0.2,
                               sparsity=min(16.0 / spec["d"], 1.0))


def partition_per_node(ds: ClassificationDataset, m: int,
                       heterogeneity: float = 0.0, seed: int = 0):
    """Split into m equal shards -> features (m, n_i, d), labels (m, n_i).

    heterogeneity=0: IID shuffle split (paper: "data is equally partitioned").
    heterogeneity→1: label-sorted split (maximally non-IID), interpolated by
    mixing a sorted fraction with a shuffled fraction.
    """
    rng = np.random.default_rng(seed)
    n = (ds.n // m) * m
    order = np.argsort(ds.labels[:n], kind="stable")
    shuffled = rng.permutation(n)
    take_sorted = int(heterogeneity * n)
    idx = np.concatenate([order[:take_sorted], shuffled[take_sorted:]])[:n]
    # deal round-robin so shard sizes match exactly
    idx = idx[rng.permutation(n)] if heterogeneity == 0 else idx
    feats = ds.features[idx].reshape(m, n // m, ds.dim)
    labels = ds.labels[idx].reshape(m, n // m)
    return {"features": feats, "labels": labels}


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenStream:
    tokens: np.ndarray  # (num_tokens,) int32
    vocab_size: int

    def batches(self, batch: int, seq_len: int, seed: int = 0):
        """Yield (tokens, labels) = (B, L) next-token pairs forever."""
        rng = np.random.default_rng(seed)
        hi = len(self.tokens) - seq_len - 1
        while True:
            starts = rng.integers(0, hi, size=batch)
            toks = np.stack([self.tokens[s:s + seq_len] for s in starts])
            labs = np.stack([self.tokens[s + 1:s + seq_len + 1] for s in starts])
            yield toks.astype(np.int32), labs.astype(np.int32)


def make_token_stream(num_tokens: int, vocab_size: int, seed: int = 0,
                      order: int = 2) -> TokenStream:
    """Zipfian unigram + sparse bigram transitions: compressible but nontrivial."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    # sparse deterministic-ish bigram structure over the top of the unigram
    succ = rng.integers(0, vocab_size, size=(vocab_size, order))
    toks = np.empty(num_tokens, dtype=np.int32)
    toks[0] = rng.choice(vocab_size, p=probs)
    follow = rng.random(num_tokens) < 0.6
    draws = rng.choice(vocab_size, size=num_tokens, p=probs)
    picks = rng.integers(0, order, size=num_tokens)
    for t in range(1, num_tokens):
        toks[t] = succ[toks[t - 1], picks[t]] if follow[t] else draws[t]
    return TokenStream(tokens=toks, vocab_size=vocab_size)
