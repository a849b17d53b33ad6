"""Sharded batching utilities.

``NodeBatcher`` draws per-node minibatches from per-node datasets (leaves
shaped (m, n, ...)) — the host-side data path for decentralized training.
``LMLoader`` shards a token stream across nodes and yields stacked LM batches
(m, per_node_batch, seq).

The port's own copy of ``repro.data.loader`` (numpy only): the same draws,
gathers and ``state_dict`` bit for bit, so a loader cursor saved in a
checkpoint by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["NodeBatcher", "LMLoader"]


@dataclasses.dataclass
class NodeBatcher:
    data: dict            # leaves (m, n, ...)
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        first = next(iter(self.data.values()))
        self.m, self.n = first.shape[0], first.shape[1]

    def sample(self) -> dict:
        idx = self._rng.integers(0, self.n, size=(self.m, self.batch_size))
        out = {}
        for k, a in self.data.items():
            gathered = np.take_along_axis(
                a, idx.reshape(self.m, self.batch_size,
                               *([1] * (a.ndim - 2))), axis=1)
            out[k] = gathered
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample()


def _encode_rng_state(obj):
    """msgpack/json-safe encoding of ``Generator.bit_generator.state``:
    PCG64 carries 128-bit ints that overflow msgpack's uint64, so every int
    is tagged and hex-encoded."""
    if isinstance(obj, dict):
        return {k: _encode_rng_state(v) for k, v in obj.items()}
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return {"__bigint__": hex(int(obj))}
    return obj


def _decode_rng_state(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__bigint__"}:
            return int(obj["__bigint__"], 16)
        return {k: _decode_rng_state(v) for k, v in obj.items()}
    return obj


@dataclasses.dataclass
class LMLoader:
    """Shards a token stream across nodes and samples stacked LM batches.

    Each node owns a CONTIGUOUS, DISJOINT shard ``tokens[i*n:(i+1)*n]`` with
    ``n = len(tokens) // num_nodes`` (the ``len(tokens) % num_nodes``
    trailing tokens are dropped).  Batches are random seq_len-windows drawn
    with replacement, so the stream never "ends": sampling past one
    epoch-worth of windows keeps drawing valid in-shard windows (windows
    never cross a shard boundary — starts are capped at
    ``n - seq_len - 1``).  The draw stream is a pure function of ``seed``
    and the number of prior draws; :meth:`state_dict` /
    :meth:`load_state_dict` round-trip the cursor exactly (the trainer's
    resume guarantee rides on this).
    """

    tokens: np.ndarray    # (num_tokens,)
    num_nodes: int
    per_node_batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # contiguous shard per node — decentralized nodes own disjoint data
        n = len(self.tokens) // self.num_nodes
        if n <= self.seq_len + 1:
            raise ValueError(
                f"shards of {n} tokens cannot fit seq_len={self.seq_len} "
                f"windows (need > seq_len + 1 tokens per node)")
        self._shards = [self.tokens[i * n:(i + 1) * n]
                        for i in range(self.num_nodes)]
        self._stacked: np.ndarray | None = None

    @property
    def shard_len(self) -> int:
        return len(self._shards[0])

    @property
    def max_start(self) -> int:
        """Exclusive upper bound for window starts (windows stay in-shard)."""
        return self.shard_len - self.seq_len - 1

    def stacked_shards(self) -> np.ndarray:
        """(m, shard_len) int32 view of all shards — the device-resident
        token buffer the resident trainer's window gathers index into."""
        if self._stacked is None:
            self._stacked = np.stack(self._shards).astype(np.int32)
        return self._stacked

    def sample_starts(self, batch_size: int | None = None) -> np.ndarray:
        """Draw (m, batch_size) window starts — ONE rng cursor advance.

        The per-node draw order matches the historical :meth:`sample` (one
        ``integers`` call per node, in node order), so index-based callers
        (the resident trainer plans all starts up front) consume the exact
        same stream as batch-based ones."""
        bs = self.per_node_batch if batch_size is None else batch_size
        return np.stack([self._rng.integers(0, self.max_start, size=bs)
                         for _ in range(self.num_nodes)])

    def gather(self, starts: np.ndarray):
        """Window gather for precomputed starts (m, B): returns
        (tokens, labels) as (m, B, L) int32 with labels the next-token
        shift."""
        L = self.seq_len
        shards = self.stacked_shards()
        win = np.arange(L + 1)
        idx = starts[:, :, None] + win[None, None, :]       # (m, B, L+1)
        full = np.take_along_axis(
            shards[:, None, :], idx.astype(np.int64), axis=2)
        return (np.ascontiguousarray(full[:, :, :L]),
                np.ascontiguousarray(full[:, :, 1:]))

    def sample(self):
        """Returns (tokens, labels): (m, B, L) int32 stacked per node."""
        return self.gather(self.sample_starts())

    def state_dict(self) -> dict:
        """Serializable data cursor (msgpack/json-safe; see
        ``_encode_rng_state`` for the bigint encoding)."""
        return {"rng": _encode_rng_state(self._rng.bit_generator.state)}

    def load_state_dict(self, state: dict) -> None:
        self._rng.bit_generator.state = _decode_rng_state(state["rng"])

    def __iter__(self):
        while True:
            yield self.sample()
