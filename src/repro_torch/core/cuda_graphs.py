"""CUDA graphs of a resident run's pieces: the port's counterpart of the
reference's compiled chunk body (``lax.scan`` over the staged steps).

The resident runner splits every chunk into pieces whose lengths are powers
of two up to ``runner.MAX_PIECE`` (``runner._pieces``) and hands each piece
to :meth:`PieceGraphs.run`.  The first piece of a length is captured into a
CUDA graph; every piece of that length replays it.  A run therefore builds
one graph per piece length, whatever its flag pattern: at most
log2(MAX_PIECE) + 1, and no more than ceil(log2(longest chunk)) + 1.

What a captured piece bakes in, and how the run feeds it:

* **Inputs.**  Each graph owns static buffers for its piece's indices,
  mixing matrices and step sizes; :meth:`PieceGraphs.run` copies the
  piece's staged slices into them on the card before the replay.
* **State.**  The run's state lives in ONE set of buffers on the card,
  cloned from the state of the first piece.  Every graph reads its first
  step's state from them and, at its end, copies the new state back into
  them (a leaf a step passes through is not copied).  Between replays the
  runner applies the outer-round transitions eagerly; :meth:`run` copies
  whatever they made back into the buffers before the next replay.  The
  state never passes through the host.
* **Warm-up.**  The run's first capture is preceded by one eager step on
  the capture stream (a side stream), on scratch copies of the state, so
  that every lazy set-up (library loads, cached index tensors, the stream's
  library workspaces) happens outside the capture; its result is
  discarded.
* **Launch counts.**  The kernel wrappers count in Python, which a replay
  does not run.  A capture records how far it moved every count; the
  warm-up's and the capture's own counts are taken back, and each replay
  adds the captured launches once.

All graphs of a run share one memory pool: their replays run one after
another on one stream, and no tensor of one graph outlives its replay.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .. import kernels

__all__ = ["PieceGraphs"]


def _clone(leaf):
    return None if leaf is None else leaf.clone()


def _store(buffers: list, leaves: list) -> None:
    """Copy a new state's leaves into the state buffers.  A leaf that is
    its own buffer (or None, as its buffer is) is skipped; a leaf that is
    ANOTHER buffer about to be overwritten is cloned first."""
    written = {id(b) for b, leaf in zip(buffers, leaves) if leaf is not b}
    pending = [(b, leaf.clone() if id(leaf) in written else leaf)
               for b, leaf in zip(buffers, leaves) if leaf is not b]
    for b, leaf in pending:
        b.copy_(leaf)


class PieceGraphs:
    """The CUDA graphs of one resident run, keyed by piece length.

    ``body(state, xs, length) -> state`` runs ``length`` steps of a piece
    from its inputs ``xs`` (indices or None, mixing matrices, step sizes,
    each with a leading step axis).  ``graphs_built``, ``replays`` and
    ``capture_s`` (seconds spent warming up and capturing) are the run's
    figures.
    """

    def __init__(self, body: Callable):
        self._body = body
        self._graphs: dict = {}          # length -> (input buffers, replay,
        #                                   launches per replay)
        self._buffers: list | None = None
        self._spec = None
        self._pool = None
        self._stream = None
        self.graphs_built = 0
        self.replays = 0
        self.capture_s = 0.0

    def run(self, state, xs, length: int):
        """Run one piece: copy ``state`` into the state buffers where it is
        not already there, the piece's inputs into the graph's buffers, and
        replay (capturing first if no graph has this length).  Returns the
        state as a tree of the state buffers."""
        self._adopt(state)
        graph = self._graphs.get(length)
        if graph is None:
            graph = self._graphs[length] = self._build(xs, length)
        inputs, replay, launches = graph
        for buf, leaf in zip(inputs, _tensor_leaves(xs)):
            buf.copy_(leaf)
        replay()
        kernels.set_launch_counts(
            [c + n for c, n in zip(kernels.launch_counts(), launches)])
        self.replays += 1
        return self.state()

    def state(self):
        return pytree.tree_unflatten(self._buffers, self._spec)

    # -- state buffers ------------------------------------------------------

    def _adopt(self, state) -> None:
        leaves, spec = pytree.tree_flatten(state)
        if self._buffers is None:
            self._buffers = [_clone(leaf) for leaf in leaves]
            self._spec = spec
            return
        if spec != self._spec:
            raise ValueError(
                f"the resident state changed its structure between pieces "
                f"({self._spec} -> {spec}); a captured piece needs a fixed "
                f"structure")
        _store(self._buffers, leaves)

    # -- capture ------------------------------------------------------------

    def _build(self, xs, length: int):
        t0 = time.perf_counter()
        inputs = [leaf.clone() for leaf in _tensor_leaves(xs)]
        static_xs = _with_tensor_leaves(xs, inputs)
        counts = kernels.launch_counts()
        if not self._graphs:
            scratch = pytree.tree_unflatten(
                [_clone(b) for b in self._buffers], self._spec)
            first = _with_tensor_leaves(xs, [a[:1] for a in inputs])
            self._warm_up(lambda: self._body(scratch, first, 1))
        before = kernels.launch_counts()

        def record():
            new = self._body(self.state(), static_xs, length)
            new_leaves, spec = pytree.tree_flatten(new)
            if spec != self._spec:
                raise ValueError(f"a step changed the state's structure "
                                 f"({self._spec} -> {spec})")
            _store(self._buffers, new_leaves)

        replay = self._capture(record)
        launches = [a - b for a, b in zip(kernels.launch_counts(), before)]
        kernels.set_launch_counts(counts)
        self.graphs_built += 1
        self.capture_s += time.perf_counter() - t0
        return inputs, replay, launches

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _warm_up(self, fn: Callable) -> None:
        """Run ``fn`` once on the capture stream (lazy set-up outside the
        capture)."""
        with torch.cuda.stream(self._side_stream()):
            fn()
        torch.cuda.current_stream().wait_stream(self._stream)

    def _capture(self, record: Callable) -> Callable:
        """Capture ``record`` into a CUDA graph on the run's capture stream,
        in the run's memory pool; returns the graph's replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._side_stream()):
            graph.capture_begin(*(() if self._pool is None
                                  else (self._pool,)))
            try:
                record()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        if self._pool is None:
            self._pool = graph.pool()
        return graph.replay


def _tensor_leaves(xs) -> list:
    return [leaf for leaf in pytree.tree_leaves(xs) if leaf is not None]


def _with_tensor_leaves(xs, tensors: list) -> Any:
    """``xs`` with its tensor leaves replaced, in order, by ``tensors``."""
    leaves, spec = pytree.tree_flatten(xs)
    it = iter(tensors)
    return pytree.tree_unflatten(
        [None if leaf is None else next(it) for leaf in leaves], spec)
