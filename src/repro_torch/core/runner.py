"""The single generic driver for every decentralized algorithm.

The port of ``repro.core.runner``.  ``run(algo, problem, schedule, spec)``
owns per-node minibatch sampling, time-varying gossip scheduling
(multi-consensus products off the schedule's slot stream), epoch /
communication / wire-byte accounting, metric recording, and outer-round
orchestration.  Algorithms only supply the state/step/outer transitions of
:class:`~repro_torch.core.algorithm.Algorithm` plus declarative metadata.

Two execution paths, chosen by the :class:`~repro_torch.core.exec_spec.
ExecSpec`:

* **host loop** (default): one step per iteration, the minibatch and the
  mixing matrix copied to the device each step, metrics pulled to the host
  at every record — the reference's host loop, step for step.
* **resident** (``resident=True``): the run is PLANNED on the host first
  (chunk schedule, gossip products, step sizes, minibatch indices drawn
  from the same ``np.random`` stream in the same order), the plan is staged
  to the device in ONE transfer, and executed from the staged tensors: each
  chunk gathers its minibatches from the resident dataset on the device.
  Metrics are written into preallocated device buffers (objective via the
  vmapped loss + prox value, consensus via device norms) and pulled to the
  host ONCE at the end.  A chunk runs as pieces whose lengths are powers of
  two up to ``MAX_PIECE``, cut wherever an outer-round transition applies;
  the transitions run eagerly between pieces.  On the CUDA device every
  piece replays a CUDA graph (``core.cuda_graphs``, one per piece length);
  on the CPU the pieces run eagerly.  ``kernel="fused"|
  "auto"`` swaps in the algorithm's fused step, whose update runs through
  the fused resident-step CUDA kernel on the card.

Coin-flip snapshot methods (``AlgoMeta.snapshot_prob``: loopless DPSVRG,
DVR) draw their coin from the same ``np.random`` stream as the reference,
after each step's minibatch indices, on both paths.  Stateful transports
(``compressed``) get their mix state through ``Algorithm.init_mix_state``.

``RunResult.extras['transfers_h2d'/'transfers_d2h']`` counts the transfer
events that either path starts itself, by the reference's rules, with one
departure: the resident path gathers its minibatches on the
device, so it does not pull the dataset to the host (the reference does).
A resident run's ``extras`` also report ``graphs_built``, ``replays`` and
``capture_s`` (0 on the CPU).

Not ported yet: the compiled ``scan=True`` path and in-chunk device
sampling (``sampling="device"``) (ROADMAP Queue 1 item 5), and batched
sweeps (``run_sweep``, Queue 1 item 8).  The
reference's executable caches (``_shared_exec``) kept XLA programs warm
across runs; eager PyTorch has nothing to keep warm, so they are gone.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from . import algorithm as algorithm_lib, cuda_graphs, gossip, graphs, \
    transport
from ..convert import params_to_numpy
from .exec_spec import ExecSpec

__all__ = ["RunHistory", "RunResult", "Recorder", "run", "run_sweep",
           "ExecSpec", "sample_batch", "objective_value",
           "traceable_consensus", "gather_batches", "CUDA_GRAPHS"]

# The resident path on the CUDA device replays CUDA graphs of its pieces.
# False runs the same pieces eagerly there, as on the CPU: the executor that
# the graphs are held to on the card.
CUDA_GRAPHS = True
# The longest piece, a power of two.  Capturing a piece costs the host about
# as long as issuing its steps eagerly, once per length; a replay costs a few
# tens of us, about a step's work on the card.  Short pieces keep the
# captures cheap and the card busy.
MAX_PIECE = 4


class RunHistory(NamedTuple):
    objective: np.ndarray          # F(x_bar) per recorded point
    consensus: np.ndarray          # mean ||x_i - x_bar||
    epochs: np.ndarray             # effective dataset passes at each point
    comm_rounds: np.ndarray        # cumulative gossip rounds
    steps: np.ndarray              # cumulative inner steps


class RunResult(NamedTuple):
    params: Any                    # final stacked iterate (on the device)
    history: RunHistory
    extras: dict                   # name -> np.ndarray from extra recorders


def sample_batch(rng: np.random.Generator, data, batch_size: int):
    """Sample per-node minibatch indices and gather on the host.  data
    leaves: numpy (m, n, ...)."""
    first = pytree.tree_leaves(data)[0]
    m, n = first.shape[0], first.shape[1]
    idx = rng.integers(0, n, size=(m, batch_size))
    return pytree.tree_map(lambda a: np.take_along_axis(
        a, idx.reshape(m, batch_size, *([1] * (a.ndim - 2))), axis=1), data)


def objective_value(loss_fn, prox, params, full_data) -> float:
    """F(x_bar) = (1/m) sum_i f_i(x_bar) + h(x_bar)."""
    return float(_composite_objective(loss_fn, prox, params, full_data))


def _composite_objective(loss_fn, prox, params, full_data):
    xbar = gossip.node_mean(params)
    m = pytree.tree_leaves(params)[0].shape[0]
    losses = torch.func.vmap(loss_fn)(gossip.stack_tree(xbar, m), full_data)
    return torch.mean(losses) + prox.value(xbar)


class Recorder:
    """Accumulates the RunHistory columns under the algorithm's metric
    conventions, plus extra metrics ``name -> fn(params) -> float`` and the
    driver-supplied ``wire_bytes`` column."""

    def __init__(self, objective_fn: Callable, meta, m: int, n: int,
                 extra_metrics: dict | None = None):
        self._obj = objective_fn
        self._meta = meta
        self._m, self._n = m, n
        self._extra = extra_metrics or {}
        self._cols = {k: [] for k in RunHistory._fields}
        self._extras = {k: [] for k in self._extra}
        self._wire: list = []

    def record(self, params, *, t: int, grad_evals: int, comm_rounds: int,
               wire_bytes: int = 0):
        meta = self._meta
        self._wire.append(wire_bytes)
        self._cols["objective"].append(self._obj(params))
        if meta.track_consensus:
            leaves = pytree.tree_leaves(params_to_numpy(params))
            cons = graphs.consensus_distance(np.stack(
                [np.concatenate([np.ravel(l[i]) for l in leaves])
                 for i in range(self._m)]))
        else:
            cons = 0.0
        self._cols["consensus"].append(cons)
        self._cols["epochs"].append(
            grad_evals / float(self._m * self._n)
            if meta.epoch_metric == "grad" else float(t))
        self._cols["comm_rounds"].append(
            comm_rounds if meta.comm_metric == "gossip" else t)
        self._cols["steps"].append(t)
        for name, fn in self._extra.items():
            self._extras[name].append(fn(params))

    def history(self) -> RunHistory:
        return RunHistory(**{k: np.array(v) for k, v in self._cols.items()})

    def extras(self) -> dict:
        out = {k: np.array(v) for k, v in self._extras.items()}
        out["wire_bytes"] = np.array(self._wire, dtype=np.int64)
        return out


# ---------------------------------------------------------------------------
# Device-resident path: plan on host, stage once, execute on the device,
# pull the history once
# ---------------------------------------------------------------------------

def traceable_consensus(params) -> torch.Tensor:
    """mean_i ||x_i - x_bar|| on the device (0-d tensor)."""
    flat = torch.cat([leaf.reshape(leaf.shape[0], -1)
                      for leaf in pytree.tree_leaves(params)], dim=1)
    xbar = flat.mean(dim=0, keepdim=True)
    return torch.linalg.vector_norm(flat - xbar, dim=1).mean()


def _resolved_objective(meta, problem):
    """The recorded objective ``obj(stacked_params, data)`` of the resident
    path: ``meta.resident_objective`` -> ``problem.objective_fn`` -> the
    composite F(x̄) via the vmapped loss + prox value."""
    if meta.resident_objective is not None:
        return meta.resident_objective
    if problem.objective_fn is not None:
        host_obj = problem.objective_fn

        def obj(params, data):
            del data
            return host_obj(params)

        return obj

    def obj(params, data):
        return _composite_objective(problem.loss_fn, problem.prox, params,
                                    data)

    return obj


def _resolve_transitions(algo, device_transitions) -> bool:
    """Whether the resident path applies ``outer``/``end_outer`` from the
    plan's per-step flags (the traced transitions) instead of as separate
    host ops between chunks."""
    meta = algo.meta
    if meta.outer_lengths is None and meta.snapshot_prob is None:
        return False                # nothing to fold
    needs_end = meta.outer_lengths is not None and algo.end_outer is not None
    has = (algo.outer is None or algo.outer_traced is not None) and \
        (not needs_end or algo.end_outer_traced is not None)
    if device_transitions == "auto":
        return has
    if device_transitions and not has:
        raise ValueError(
            f"{meta.name}: device_transitions=True needs the traceable "
            f"outer-transition contract (Algorithm.outer_traced"
            f"{' + end_outer_traced' if needs_end else ''})")
    return bool(device_transitions)


def _resolve_kernel_step(algo, kernel: str):
    """The resident step for a ``kernel=`` mode: the algorithm's fused twin
    for "fused"/"auto" when the method declares one, else the plain step."""
    if kernel != "plain" and algo.meta.fused_step is not None:
        return algo.meta.fused_step(kernel)
    return algo.step


class _Chunk(NamedTuple):
    xs: tuple                      # host (indices | None, phis, alphas)
    flags: tuple | None            # host (o_pre, o_post, e_post, e_k) or None

    @property
    def length(self) -> int:
        return len(self.xs[2])


class _Plan(NamedTuple):
    ops: list                      # ("chunk", i) | ("outer",) |
    #                                ("end_outer", K) | ("record",)
    chunks: list
    cols: dict                     # host-computable history columns
    wire: np.ndarray               # cumulative wire bytes per record
    num_records: int


def _plan_resident(meta, rng, backend, aux, *, m: int, n: int,
                   param_count: int, record_every: int,
                   transitions: bool) -> _Plan:
    """Walk the run's data-independent control flow without touching the
    device: chunk boundaries, gossip products, step sizes, minibatch
    indices (same ``np.random`` draw order as the host loop) and
    every host-computable history column.  With ``transitions=True`` the
    plan holds no ``outer``/``end_outer`` ops: per-step flags say where the
    algorithm's traced transitions apply (before a step: a new outer round;
    after it: a coin-flip snapshot, or the end of a round).  Without them a
    coin flip cuts the chunk and an ``outer`` op follows it."""
    has_batch = meta.batch_size > 0
    bsz = meta.batch_size
    has_snapshot = meta.snapshot_prob is not None

    ops: list = []
    chunks: list = []
    cols = {"epochs": [], "comm_rounds": [], "steps": []}
    wire_col: list = []

    grad_evals = m * n if meta.init_full_grad else 0
    full_grad_cost = m * n
    comm = 0
    wire = 0
    slot = meta.slot_start
    t = 0

    def phi_for(rounds: int):
        nonlocal slot, comm, wire
        phi = backend.phi_for(aux, slot, rounds)
        wire += (backend.bytes_per_step(aux, phi, param_count)
                 * meta.gossip_payloads)
        slot += rounds
        comm += rounds
        return phi

    def plan_record():
        ops.append(("record",))
        cols["epochs"].append(grad_evals / float(m * n)
                              if meta.epoch_metric == "grad" else float(t))
        cols["comm_rounds"].append(comm if meta.comm_metric == "gossip"
                                   else t)
        cols["steps"].append(t)
        wire_col.append(wire)

    def finish_chunk(idxs, phis, alphas, flags):
        """Stack one chunk's step inputs: the minibatch indices as one
        (chunk, m, bsz) int array (the batches are gathered on the device),
        the wire representations and the step sizes."""
        idx = np.stack(idxs) if has_batch else None
        chunk_flags = None
        if transitions:
            chunk_flags = (np.array(flags["o_pre"], np.bool_),
                           np.array(flags["o_post"], np.bool_),
                           np.array(flags["e_post"], np.bool_),
                           np.array(flags["e_k"], np.float32))
        ops.append(("chunk", len(chunks)))
        chunks.append(_Chunk((idx, _stack_wire(phis),
                              np.asarray(alphas, np.float32)), chunk_flags))

    def draw_idx():
        return rng.integers(0, n, size=(m, bsz))

    plan_record()

    if meta.outer_lengths is not None:
        # ---- outer/inner structure (DPSVRG) --------------------------------
        just_recorded = False
        pending_outer = False
        for K in meta.outer_lengths:
            if transitions:
                pending_outer = True
            else:
                ops.append(("outer",))
            if meta.outer_full_grad:
                grad_evals += full_grad_cost
            k = 0
            while k < K:
                key0 = k if meta.record_key == "round" else t
                until = (record_every - key0 % record_every
                         if record_every else K - k)
                chunk = min(K - k, until)
                idxs, phis, alphas = [], [], []
                flags = {"o_pre": [], "o_post": [], "e_post": [], "e_k": []}
                for j in range(chunk):
                    if has_batch:
                        idxs.append(draw_idx())
                    phis.append(phi_for(meta.gossip_rounds(k + j + 1)))
                    alphas.append(meta.stepsize(t + j + 1))
                    if transitions:
                        flags["o_pre"].append(pending_outer)
                        pending_outer = False
                        flags["o_post"].append(False)
                        flags["e_post"].append(k + j + 1 == K)
                        flags["e_k"].append(float(K))
                finish_chunk(idxs, phis, alphas, flags)
                k += chunk
                t += chunk
                grad_evals += chunk * meta.step_grad_factor * m * bsz
                key = k if meta.record_key == "round" else t
                if record_every and key % record_every == 0:
                    plan_record()
                    just_recorded = True
                else:
                    just_recorded = False
            if not transitions:
                ops.append(("end_outer", K))
            if not record_every:
                plan_record()
        if record_every and meta.final_record and not just_recorded:
            plan_record()
    else:
        # ---- flat loop (DSPG) ----------------------------------------------
        if record_every < 1:
            raise ValueError(
                f"{meta.name}: flat loops need record_every >= 1")
        while t < meta.num_steps:
            chunk_max = min(meta.num_steps - t,
                            record_every - t % record_every)
            idxs, phis, alphas = [], [], []
            flags = {"o_pre": [], "o_post": [], "e_post": [], "e_k": []}
            refresh = False
            chunk = 0
            for j in range(chunk_max):
                if has_batch:
                    idxs.append(draw_idx())
                phis.append(phi_for(meta.gossip_rounds(t + j + 1)))
                alphas.append(meta.stepsize(t + j + 1))
                chunk += 1
                # the coin of a snapshot method comes after the step's
                # indices, as in the host loop
                flip = has_snapshot and rng.random() < meta.snapshot_prob
                if transitions:
                    flags["o_pre"].append(False)
                    flags["o_post"].append(flip)
                    flags["e_post"].append(False)
                    flags["e_k"].append(0.0)
                    if flip and meta.outer_full_grad:
                        grad_evals += full_grad_cost
                elif flip:
                    refresh = True   # the snapshot lands here: cut the chunk
                    break
            finish_chunk(idxs, phis, alphas, flags)
            t += chunk
            grad_evals += chunk * meta.step_grad_factor * m * bsz
            if refresh:
                ops.append(("outer",))
                if meta.outer_full_grad:
                    grad_evals += full_grad_cost
            if t % record_every == 0 or t == meta.num_steps:
                plan_record()

    num_records = sum(1 for op in ops if op[0] == "record")
    return _Plan(ops=ops, chunks=chunks,
                 cols={k: np.array(v) for k, v in cols.items()},
                 wire=np.array(wire_col, dtype=np.int64),
                 num_records=num_records)


def _stack_wire(phis):
    """Stack per-step wire representations (each a pytree: a dense array, a
    ``BandedPhi``, a ``CompressedPhi``) leaf by leaf along a new leading
    step axis.  Float leaves become float32; integer payloads keep their
    dtype."""
    flat = [pytree.tree_flatten(p) for p in phis]
    spec = flat[0][1]
    stacked = []
    for col in zip(*(leaves for leaves, _ in flat)):
        out = np.stack([np.asarray(a) for a in col])
        if np.issubdtype(out.dtype, np.floating):
            out = out.astype(np.float32, copy=False)
        stacked.append(out)
    return pytree.tree_unflatten(stacked, spec)


def _stage(chunks, device) -> list:
    """Ship every chunk's (indices, phis, alphas) to the device as one
    tensor per leaf; returns each chunk's device xs as views of those."""
    specs = [pytree.tree_flatten(c.xs) for c in chunks]
    spec = specs[0][1]
    staged = [None if col[0] is None
              else torch.from_numpy(np.concatenate(col)).to(device)
              for col in zip(*(leaves for leaves, _ in specs))]
    out, start = [], 0
    for c in chunks:
        stop = start + c.length
        views = [None if s is None else s[start:stop] for s in staged]
        out.append(pytree.tree_unflatten(views, spec))
        start = stop
    return out


def gather_batches(data, idx: torch.Tensor):
    """The minibatches of a run of steps, gathered from the resident
    dataset on its device: ``data`` leaves (m, n, ...), ``idx`` the (steps,
    m, bsz) int64 indices -> leaves (steps, m, bsz, ...), element for
    element what a host ``np.take_along_axis`` of the same indices gives."""
    steps, m, bsz = idx.shape
    return pytree.tree_map(
        lambda a: torch.take_along_dim(
            a[None], idx.reshape(steps, m, bsz, *([1] * (a.ndim - 2))),
            dim=2), data)


def _slice(xs, start: int, stop: int):
    leaves, spec = pytree.tree_flatten(xs)
    return pytree.tree_unflatten(
        [None if a is None else a[start:stop] for a in leaves], spec)


def _pieces(chunk: _Chunk) -> list:
    """(start, length) pieces that cover the chunk's steps in order: a cut
    before every step whose ``o_pre`` flag fires and after every step whose
    ``o_post`` or ``e_post`` flag fires, and each stretch between cuts split
    into pieces of ``MAX_PIECE`` steps, then the binary digits of what is
    left, largest first.  Every length is a power of two, so a run's pieces
    take at most min(ceil(log2(longest chunk)), log2(MAX_PIECE)) + 1
    distinct lengths."""
    cuts = {0, chunk.length}
    if chunk.flags is not None:
        o_pre, o_post, e_post, _ = chunk.flags
        cuts.update(int(j) for j in np.flatnonzero(o_pre))
        cuts.update(int(j) + 1 for j in np.flatnonzero(o_post | e_post))
    bounds = sorted(cuts)
    out = []
    for start, stop in zip(bounds, bounds[1:]):
        while stop - start > MAX_PIECE:
            out.append((start, MAX_PIECE))
            start += MAX_PIECE
        for bit in reversed(range((stop - start).bit_length())):
            if (stop - start) >> bit & 1:
                out.append((start, 1 << bit))
                start += 1 << bit
    return out


def _piece_body(step_fn, data_dev, has_batch: bool):
    """``body(state, xs, length) -> state``: ``length`` staged steps, their
    minibatches gathered from the resident dataset in one take per leaf."""
    def body(state, xs, length: int):
        idx, phis, alphas = xs
        batches = gather_batches(data_dev, idx) if has_batch else None
        for j in range(length):
            b = pytree.tree_map(lambda a: a[j], batches) if has_batch \
                else None
            phi = pytree.tree_map(lambda a: a[j], phis)
            state = step_fn(state, b, phi, alphas[j])
        return state

    return body


def _exec_chunk(state, chunk: _Chunk, xs, algo, data_dev, run_piece):
    """Run one staged chunk piece by piece, applying the traced outer
    transitions between pieces where the host-side flags say."""
    flags = chunk.flags
    for start, length in _pieces(chunk):
        last = start + length - 1
        if flags is not None and flags[0][start]:
            state = algo.outer_traced(state, data_dev)
        state = run_piece(state, _slice(xs, start, start + length), length)
        if flags is not None and flags[1][last]:
            state = algo.outer_traced(state, data_dev)
        if flags is not None and flags[2][last]:
            state = algo.end_outer_traced(state, float(flags[3][last]))
    return state


def _piece_runner(device: torch.device, body):
    """-> (run_piece, its ``PieceGraphs`` or None): graph replays on the
    CUDA device, the body itself (eager) on the CPU."""
    if device.type == "cuda" and CUDA_GRAPHS:
        pieces = cuda_graphs.PieceGraphs(body)
        return pieces.run, pieces
    return body, None


def _run_resident(algo, problem, backend, aux, rng, *, m: int, n: int,
                  param_count: int, record_every: int, device, kernel: str,
                  device_transitions, extra_metrics,
                  transfers) -> RunResult:
    meta = algo.meta
    if extra_metrics:
        raise ValueError(
            "resident=True records metrics on device; host-side "
            "extra_metrics callables need the host loop")
    has_batch = meta.batch_size > 0
    transitions = _resolve_transitions(algo, device_transitions)

    # spans for torch.profiler (nothing is recorded when it is off): the
    # host's plan and its staging copy, issuing the chunks, the pull
    with record_function("resident.plan"):
        plan = _plan_resident(
            meta, rng, backend, aux, m=m, n=n, param_count=param_count,
            record_every=record_every, transitions=transitions)
    step_fn = _resolve_kernel_step(algo, kernel)
    objective = _resolved_objective(meta, problem)

    # the dataset already lies on the device (runner.run checks it): only
    # the plan is staged, and the chunks gather their minibatches from it
    data_dev = problem.full_data
    with record_function("resident.stage"):
        staged = _stage(plan.chunks, device)   # ONE staging transfer
    transfers["h2d"] += 1

    run_piece, piece_graphs = _piece_runner(
        device, _piece_body(step_fn, data_dev, has_batch))
    with record_function("resident.execute"):
        state = inject_mix_state(algo, backend, aux, algo.init())
        if transitions and algo.device_state is not None:
            state = algo.device_state(state)
        bufs = torch.zeros((2, plan.num_records), dtype=torch.float32,
                           device=device)      # objective, consensus
        slot = 0
        for op in plan.ops:
            kind = op[0]
            if kind == "chunk":
                state = _exec_chunk(state, plan.chunks[op[1]],
                                    staged[op[1]], algo, data_dev, run_piece)
            elif kind == "record":
                params = algo.get_params(state)
                bufs[0, slot] = objective(params, data_dev)
                if meta.track_consensus:
                    bufs[1, slot] = traceable_consensus(params)
                slot += 1
            elif kind == "outer":
                state = algo.outer(state)
            elif algo.end_outer is not None:    # ("end_outer", K)
                state = algo.end_outer(state, op[1])

    with record_function("resident.pull"):
        history_buf = bufs.cpu().numpy()       # the ONE history pull
    transfers["d2h"] += 1

    history = RunHistory(
        objective=np.asarray(history_buf[0], np.float64),
        consensus=np.asarray(history_buf[1], np.float64),
        epochs=plan.cols["epochs"],
        comm_rounds=plan.cols["comm_rounds"],
        steps=plan.cols["steps"])
    extras = {"wire_bytes": plan.wire,
              "transfers_h2d": transfers["h2d"],
              "transfers_d2h": transfers["d2h"],
              "graphs_built": 0, "replays": 0, "capture_s": 0.0}
    if piece_graphs is not None:
        extras.update(graphs_built=piece_graphs.graphs_built,
                      replays=piece_graphs.replays,
                      capture_s=piece_graphs.capture_s)
    return RunResult(params=algo.get_params(state), history=history,
                     extras=extras)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _resolve_device(spec: ExecSpec) -> torch.device:
    """The run's device.  A CUDA run without a CUDA device raises: the port
    never carries on on the CPU unless asked to."""
    device = spec.torch_device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "runner.run executes on the CUDA device by default, and "
                "none is available; pass ExecSpec(device='cpu') to run on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # float32 products (the full-gradient matrix products among them)
        # run in full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _check_on_device(problem, device: torch.device) -> None:
    for name, tree in (("x0", problem.x0), ("full_data", problem.full_data)):
        for leaf in pytree.tree_leaves(tree):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"problem.{name} must hold torch tensors "
                                f"(see repro_torch.convert), got "
                                f"{type(leaf).__name__}")
            if leaf.device != device:
                raise ValueError(f"problem.{name} lies on {leaf.device} but "
                                 f"the run executes on {device}; build the "
                                 f"problem on the run's device")


def inject_mix_state(algo, backend, aux, state):
    """Give ``state`` the transport state a stateful backend needs: the
    algorithm owns where it lives (``Algorithm.init_mix_state``), the
    backend what it is (its ``init_mix_state(aux, x0)``)."""
    if not backend.needs_mix_state:
        return state
    if algo.init_mix_state is None:
        raise ValueError(
            f"{algo.meta.name} does not thread a gossip mix state "
            f"(Algorithm.init_mix_state is None), so it cannot be "
            f"driven by the stateful {backend.name!r} transport")
    return algo.init_mix_state(
        state, make=lambda x0: backend.init_mix_state(aux, x0))


def _resolved_backend(gossip, schedule, meta):
    """Resolve the transport and honour hp-level quantization: a method that
    quantizes its own gossip payload (``AlgoMeta.compress_bits``) gets its
    transport wrapped in a ``CompressedBackend`` at those bits, so the wire
    accounting matches what moves (a conflicting compressed transport
    raises)."""
    backend = transport.resolve_backend(gossip, schedule, meta)
    if meta.compress_bits is not None:
        if isinstance(backend, transport.CompressedBackend):
            if backend.bits != meta.compress_bits:
                raise ValueError(
                    f"conflicting compression: the algorithm quantizes its "
                    f"gossip at {meta.compress_bits} bits "
                    f"(meta.compress_bits) but the requested transport "
                    f"compresses at {backend.bits} bits; drop one of the "
                    f"two, or make them agree")
        else:
            backend = transport.CompressedBackend(inner=backend,
                                                  bits=meta.compress_bits)
    return backend


def run(algo: algorithm_lib.Algorithm,
        problem: algorithm_lib.Problem,
        schedule: graphs.MixingSchedule,
        exec: "ExecSpec | None" = None,
        *,
        seed: int = 0,
        record_every: int = 1,
        extra_metrics: dict | None = None) -> RunResult:
    """Drive ``algo`` on ``problem`` over the time-varying ``schedule``.

    exec:          the :class:`ExecSpec`; ``None`` is ``ExecSpec()``, the
                   host loop on the CUDA device.  The problem's tensors
                   must lie on ``exec.device``.
    seed:          seeds the ``np.random`` minibatch stream (the
                   reference's, draw for draw).
    record_every:  history cadence in inner steps; 0 = once per outer round
                   (outer/inner methods only).
    extra_metrics: ``{name: fn(stacked_params) -> float}`` recorded by the
                   host loop next to the standard columns (in ``extras``,
                   beside the always-present ``wire_bytes``).
    """
    spec = ExecSpec() if exec is None else exec
    if not isinstance(spec, ExecSpec):
        raise TypeError(f"runner.run: exec must be an ExecSpec, got "
                        f"{type(spec).__name__}")
    if spec.scan:
        raise NotImplementedError(
            "scan=True (compiled chunk path) is not ported to PyTorch yet "
            "(ROADMAP Queue 1 item 5); use the host loop or resident=True")
    if spec.sampling == "device":
        raise NotImplementedError(
            "sampling='device' is not ported to PyTorch yet (ROADMAP "
            "Queue 1 item 5); use sampling='host'")
    meta = algo.meta
    device = _resolve_device(spec)
    _check_on_device(problem, device)
    backend = _resolved_backend(spec.gossip, schedule, meta)
    aux = backend.prepare(schedule, meta)
    rng = np.random.default_rng(seed)
    m = pytree.tree_leaves(problem.x0)[0].shape[0]
    n = pytree.tree_leaves(problem.full_data)[0].shape[1]
    param_count = transport.node_param_count(problem.x0)
    # driver-initiated host<->device transfer EVENTS (one per staged tree /
    # per metric pull), counted by the reference's rules
    transfers = {"h2d": 0, "d2h": 0}

    if spec.resident:
        return _run_resident(algo, problem, backend, aux, rng, m=m, n=n,
                             param_count=param_count,
                             record_every=record_every, device=device,
                             kernel=spec.kernel,
                             device_transitions=spec.device_transitions,
                             extra_metrics=extra_metrics,
                             transfers=transfers)

    obj = problem.objective_fn or (
        lambda p: objective_value(problem.loss_fn, problem.prox, p,
                                  problem.full_data))
    rec = Recorder(obj, meta, m, n, extra_metrics)
    # sample minibatches from a host-side copy
    host_data = None
    if meta.batch_size > 0:
        host_data = params_to_numpy(problem.full_data)
        transfers["d2h"] += 1

    state = inject_mix_state(algo, backend, aux, algo.init())
    grad_evals = m * n if meta.init_full_grad else 0
    full_grad_cost = m * n
    comm = 0
    wire = 0
    slot = meta.slot_start
    t = 0

    def phi_for(rounds: int):
        nonlocal slot, comm, wire
        phi = backend.phi_for(aux, slot, rounds)
        slot += rounds
        comm += rounds
        wire += (backend.bytes_per_step(aux, phi, param_count)
                 * meta.gossip_payloads)
        transfers["h2d"] += 1
        return pytree.tree_map(
            lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=device), phi)

    def next_batch():
        if meta.batch_size == 0:
            return None
        transfers["h2d"] += 1
        return pytree.tree_map(lambda a: torch.from_numpy(a).to(device),
                               sample_batch(rng, host_data, meta.batch_size))

    def stepsize(step_t: int) -> float:
        # the reference passes jnp.float32(stepsize): round to float32
        return float(np.float32(meta.stepsize(step_t)))

    def do_record():
        transfers["d2h"] += 1 + (1 if meta.track_consensus else 0)
        rec.record(algo.get_params(state), t=t, grad_evals=grad_evals,
                   comm_rounds=comm, wire_bytes=wire)

    do_record()

    if meta.outer_lengths is not None:
        # ---- outer/inner structure (DPSVRG) --------------------------------
        just_recorded = False
        for K in meta.outer_lengths:
            state = algo.outer(state)
            if meta.outer_full_grad:
                grad_evals += full_grad_cost
            for k in range(1, K + 1):
                t += 1
                batch = next_batch()
                phi = phi_for(meta.gossip_rounds(k))
                state = algo.step(state, batch, phi, stepsize(t))
                grad_evals += meta.step_grad_factor * m * meta.batch_size
                key = k if meta.record_key == "round" else t
                just_recorded = bool(record_every
                                     and key % record_every == 0)
                if just_recorded:
                    do_record()
            if algo.end_outer is not None:
                state = algo.end_outer(state, K)
            if not record_every:
                do_record()
        if record_every and meta.final_record and not just_recorded:
            do_record()
    else:
        # ---- flat loop (DSPG) ----------------------------------------------
        if record_every < 1:
            raise ValueError(
                f"{meta.name}: flat loops need record_every >= 1")
        while t < meta.num_steps:
            t += 1
            batch = next_batch()
            phi = phi_for(meta.gossip_rounds(t))
            state = algo.step(state, batch, phi, stepsize(t))
            grad_evals += meta.step_grad_factor * m * meta.batch_size
            if (meta.snapshot_prob is not None
                    and rng.random() < meta.snapshot_prob):
                state = algo.outer(state)
                if meta.outer_full_grad:
                    grad_evals += full_grad_cost
            if t % record_every == 0 or t == meta.num_steps:
                do_record()

    extras = rec.extras()
    extras["transfers_h2d"] = transfers["h2d"]
    extras["transfers_d2h"] = transfers["d2h"]
    return RunResult(params=algo.get_params(state), history=rec.history(),
                     extras=extras)


def run_sweep(*args, **kwargs):
    """Batched hyper-parameter sweeps: not ported yet."""
    raise NotImplementedError(
        "runner.run_sweep (batched sweeps) is not ported to PyTorch yet "
        "(ROADMAP Queue 1 item 8); loop over runner.run")
