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
  cloned from the state of the first piece (a batched sweep's state is the
  same tree with a leading cell axis).  Every graph reads its first
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

The capture stream, the pool, the warm-up and the launch accounting are
:class:`GraphCapture`'s, which :class:`PieceGraphs` extends; the serving
engine's decode chunk (``serve/engine.py``) is captured through it too.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .. import kernels

__all__ = ["GraphCapture", "PieceGraphs", "store"]


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


def store(buffers: list, spec, tree) -> None:
    """Copy ``tree`` into ``buffers``, the leaves of a tree of structure
    ``spec``, as :func:`_store` does; a captured step ends with it.  Raises
    ``ValueError`` where ``tree`` has another structure."""
    leaves, new_spec = pytree.tree_flatten(tree)
    if new_spec != spec:
        raise ValueError(f"a step changed the state's structure "
                         f"({spec} -> {new_spec})")
    _store(buffers, leaves)


class GraphCapture:
    """The capture stream and memory pool of a set of CUDA graphs, with the
    kernel wrappers' launch counts kept straight around them.

    :meth:`new_graph` warms up, captures, and returns the replay.  Graphs
    made by one ``GraphCapture`` share its pool, so they must replay one
    after another on one stream.
    """

    def __init__(self):
        self._pool = None
        self._stream = None

    def new_graph(self, record: Callable,
                  warm_up: Callable | None = None) -> Callable[[], None]:
        """Run ``warm_up`` (if given) once on the capture stream, then
        capture ``record``.  Returns the graph's replay, which adds the
        launches the capture recorded to the kernel wrappers' counts.  The
        launch counts that the warm-up or the capture moved are taken back,
        also where one raises."""
        counts = kernels.launch_counts()
        try:
            if warm_up is not None:
                self._warm_up(warm_up)
            before = kernels.launch_counts()
            graph_replay = self._capture(record)
            launches = [a - b for a, b in
                        zip(kernels.launch_counts(), before)]
        finally:
            kernels.set_launch_counts(counts)

        def replay():
            graph_replay()
            kernels.set_launch_counts(
                [c + n for c, n in zip(kernels.launch_counts(), launches)])

        return replay

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
        """Capture ``record`` into a CUDA graph on the capture stream, in
        the shared memory pool; returns the graph's replay."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(self._side_stream()):
                graph.capture_begin(*(() if self._pool is None
                                      else (self._pool,)))
                try:
                    record()
                finally:
                    graph.capture_end()
        except RuntimeError:
            _release_generators()
            raise
        torch.cuda.current_stream().wait_stream(self._stream)
        if self._pool is None:
            self._pool = graph.pool()
        return graph.replay


class PieceGraphs(GraphCapture):
    """The CUDA graphs of one resident run, keyed by piece length.

    ``body(state, xs, length) -> state`` runs ``length`` steps of a piece
    from its inputs ``xs`` (indices or None, mixing matrices, step sizes,
    each with a leading step axis).  ``graphs_built``, ``replays`` and
    ``capture_s`` (seconds spent warming up and capturing) are the run's
    figures.
    """

    def __init__(self, body: Callable):
        super().__init__()
        self._body = body
        self._graphs: dict = {}          # length -> (input buffers, replay)
        self._buffers: list | None = None
        self._spec = None
        self.graphs_built = 0
        self.replays = 0
        self.capture_s = 0.0

    def run(self, state, xs, length: int):
        """Run one piece: copy ``state`` into the state buffers where it is
        not already there, the piece's inputs into the graph's buffers, and
        replay (capturing first if no graph has this length).  Returns the
        state as a tree of the state buffers."""
        self._adopt(state)
        entry = self._graphs.get(length)
        if entry is None:
            entry = self._graphs[length] = self._build(xs, length)
        inputs, replay = entry
        for buf, leaf in zip(inputs, _tensor_leaves(xs)):
            buf.copy_(leaf)
        replay()
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
        warm_up = None
        if not self._graphs:
            scratch = pytree.tree_unflatten(
                [_clone(b) for b in self._buffers], self._spec)
            first = _with_tensor_leaves(xs, [a[:1] for a in inputs])

            def warm_up():
                self._body(scratch, first, 1)

        def record():
            store(self._buffers, self._spec,
                  self._body(self.state(), static_xs, length))

        replay = self.new_graph(record, warm_up)
        self.graphs_built += 1
        self.capture_s += time.perf_counter() - t0
        return inputs, replay


def _release_generators() -> None:
    """Take torch's CUDA generators out of capture mode after a failed
    capture.  Where ``capture_end`` raises (a capture invalidated by a host
    sync, say), it raises before it releases them (torch 2.11), and every
    later random draw on the card then raises; a capture that ends cleanly
    releases them.  ``tests/test_torch_card.py::
    test_a_failed_capture_leaves_the_generators_in_capture_mode`` fails
    once torch releases them itself."""
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        torch.zeros(1, device="cuda")


def _tensor_leaves(xs) -> list:
    return [leaf for leaf in pytree.tree_leaves(xs) if leaf is not None]


def _with_tensor_leaves(xs, tensors: list) -> Any:
    """``xs`` with its tensor leaves replaced, in order, by ``tensors``."""
    leaves, spec = pytree.tree_flatten(xs)
    it = iter(tensors)
    return pytree.tree_unflatten(
        [None if leaf is None else next(it) for leaf in leaves], spec)
