"""Batched resident sweeps: a whole hyperparameter grid as one resident
program on the card.  The port of ``repro.core.sweep``.

The paper's experiments are sweeps: seeds over four datasets (Fig. 1), a
λ grid (Fig. 4), a connectivity grid (Fig. 5).  :func:`run_sweep` runs a
grid as ONE resident run whose state carries a leading cell axis: the
cells' control flow (identical by construction; the driver validates it)
is planned once, every cell's inputs are staged in one step, each piece of
a chunk runs every cell's steps under ``torch.func.vmap`` over the cell
axis (on the card: a CUDA graph of the piece, as in a single resident run),
the outer-round transitions and the records run cell by cell between
pieces, and one (records, cells) history comes back at the end.

The contract
------------

``run_sweep(build, grid, schedule)`` takes a cell factory

    build(**cell) -> (Algorithm, Problem)

and a ``grid`` mapping axis names to value lists.  Two axis names are
handled by the driver and not passed to ``build``:

* ``"seed"`` — each cell's ``np.random`` stream (minibatch indices,
  loopless coin flips, the device stream's key), drawn in the order of a
  sequential ``runner.run(seed=...)``, so batched histories equal
  sequential ones to float tolerance;
* ``"schedule"`` — each cell's :class:`~repro_torch.core.graphs.
  MixingSchedule` (topology grids).  Cells may gossip over different
  schedules when their wire representations share their static structure:
  ``gossip="dense"`` always does; banded cells need one offset union
  (:func:`~repro_torch.core.transport.batch_phis` raises otherwise).

``build`` is called once per cell with the values themselves (validation,
the host's plan — step sizes, loop lengths — and the cell's transitions
and records), and again in each piece of steps, under ``torch.func.vmap``
with each axis value a 0-d float32 tensor, so that its closures
(``prox.l1(lam)``, a loss weight) compute each cell's math from its own
value.  Axes that change the run's
structure (loop lengths, batch sizes, gossip rounds, the dataset) are
refused as a "ragged sweep grid": batch what shares a shape, loop over the
rest.

The fused step (``ExecSpec(kernel="fused"|"auto")``) runs under the vmap
too: its launch sits in a ``torch.autograd.Function`` whose vmap rule is
the cell-batched launch of ``fused_step`` (``kernels.fused_update.ops``),
so one launch serves every cell of a step.  The dataset lies on the device
once, shared by all cells: the pieces gather every cell's minibatches from
it.  The transitions and the records (full gradients and objectives over
the whole dataset) run cell by cell between pieces, since under a vmap
over the cells PyTorch's batching rule for the product of the shared
dataset with the cells' iterates copies the dataset once per cell.
Loopless coin flips differ per cell: at a step where some cell flips, the
refresh runs for the cells that flipped, and only for them.

Execution follows the :class:`~repro_torch.core.exec_spec.ExecSpec`: the
default ``ExecSpec(resident=True)`` is the batched run; ``batched=False``
runs the cells as sequential resident runs (the baseline the batched run is
held and timed against); ``ExecSpec(resident=False)`` runs them through the
host loop, or the scan path with ``scan=True``.  With
``sampling="device"`` every cell draws its minibatches on the device from
its own stream (``core.device_sampling``), its key drawn from the cell's
``np.random`` stream before the plan, so each cell equals its sequential
device-sampled run.  PyTorch compiles nothing, so the reference's executor
cache has no counterpart.  All modes return the same :class:`SweepResult`.

``ExecSpec(shard="cells")`` splits the grid over the mesh's ``"cells"`` dim
(by default a 1-D ``("cells",)`` mesh over every rank of the default group;
``core.spmd``): each rank runs its contiguous slice of the cells as the
batched program above, and the histories, wire columns and parameters are
gathered to every rank in grid order.  The grid must split evenly over the
dim.  Transports that exchange over a node axis of ranks (``ppermute``, and
wrappers around it) cannot ride a batched sweep: the cells' steps run under
one vmap.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import device_sampling as device_sampling_lib, runner as runner_lib, \
    spmd, transport
from ..spans import span
from .exec_spec import ExecSpec

__all__ = ["SweepResult", "expand_grid", "run_sweep"]

_RESERVED_AXES = ("seed", "schedule")

# AlgoMeta fields that define the run's STRUCTURE: every cell of a batched
# sweep must agree on them (numeric fields like stepsize values and
# snapshot probabilities are free to vary).
_STRUCT_FIELDS = (
    "outer_lengths", "num_steps", "batch_size", "step_grad_factor",
    "outer_full_grad", "init_full_grad", "gossip_payloads", "slot_start",
    "track_consensus", "comm_metric", "epoch_metric", "record_key",
    "final_record", "compress_bits",
)


class SweepResult(NamedTuple):
    """Stacked result of a sweep: every history column is ``(records,
    cells)``; ``params`` leaves carry a leading cell axis; ``grid`` is the
    expanded cell list (reserved axes included).  ``extras['wire_bytes']``
    is ``(records, cells)``; ``extras['transfers_h2d'/'transfers_d2h']``
    count the transfers the driver starts for the WHOLE sweep (one each
    for a batched sweep)."""

    grid: list
    params: Any
    history: Any                   # runner.RunHistory, columns (R, B)
    extras: dict

    def cell(self, i: int) -> runner_lib.RunResult:
        """The i-th cell's result as a plain ``runner.RunResult``."""
        hist = runner_lib.RunHistory(
            **{f: np.asarray(getattr(self.history, f))[:, i]
               for f in runner_lib.RunHistory._fields})
        extras = dict(self.extras)
        extras["wire_bytes"] = np.asarray(self.extras["wire_bytes"])[:, i]
        return runner_lib.RunResult(
            params=pytree.tree_map(lambda leaf: leaf[i], self.params),
            history=hist, extras=extras)


def expand_grid(grid: dict, mode: str = "product") -> list:
    """Expand ``{axis: values}`` into a list of cell dicts — the cartesian
    ``"product"`` (default) or the elementwise ``"zip"`` of the axes."""
    if not grid:
        raise ValueError("empty sweep grid: pass at least one axis, e.g. "
                         "{'seed': [0, 1, 2]} or {'lam': [1e-3, 1e-2]}")
    names = list(grid)
    values = [list(v) for v in grid.values()]
    if any(len(v) == 0 for v in values):
        raise ValueError(f"sweep grid axis with no values: "
                         f"{[n for n, v in zip(names, values) if not v]}")
    if mode == "product":
        combos = itertools.product(*values)
    elif mode == "zip":
        lens = sorted({len(v) for v in values})
        if len(lens) > 1:
            raise ValueError(
                f"zip-mode sweep axes must share one length, got "
                f"{ {n: len(v) for n, v in zip(names, values)} }")
        combos = zip(*values)
    else:
        raise ValueError(f"unknown grid mode {mode!r}: 'product' or 'zip'")
    return [dict(zip(names, combo)) for combo in combos]


# ---------------------------------------------------------------------------
# Grid validation: refuse anything that changes the run's structure
# ---------------------------------------------------------------------------

def _ragged(what: str) -> ValueError:
    return ValueError(
        f"ragged sweep grid: {what}.  A batched sweep runs every cell "
        f"through ONE batched program, so cells must share the run "
        f"structure (loop lengths, batch sizes, gossip policy, dataset, "
        f"parameter shapes); sweep numeric hyperparameters — seeds, step "
        f"sizes, lambdas, init points — and loop over structural ones.")


def _leaf_key(leaf):
    return (tuple(leaf.shape), leaf.dtype)


def _validate_cells(cells, built, schedules) -> None:
    metas = [algo.meta for algo, _ in built]
    meta0 = metas[0]
    for i, meta in enumerate(metas[1:], 1):
        for f in _STRUCT_FIELDS:
            if getattr(meta, f) != getattr(meta0, f):
                raise _ragged(
                    f"cell {i} ({cells[i]}) has AlgoMeta.{f}="
                    f"{getattr(meta, f)!r} vs {getattr(meta0, f)!r} in "
                    f"cell 0 ({cells[0]})")
        if (meta.snapshot_prob is None) != (meta0.snapshot_prob is None):
            raise _ragged(
                f"cell {i} ({cells[i]}) toggles coin-flip snapshots "
                f"(snapshot_prob {meta.snapshot_prob!r} vs "
                f"{meta0.snapshot_prob!r})")
    horizon = (max(meta0.outer_lengths)
               if meta0.outer_lengths is not None
               else (meta0.num_steps or 1))
    rounds0 = [meta0.gossip_rounds(k) for k in range(1, horizon + 1)]
    for i, meta in enumerate(metas[1:], 1):
        if [meta.gossip_rounds(k)
                for k in range(1, horizon + 1)] != rounds0:
            raise _ragged(
                f"cell {i} ({cells[i]}) uses a different gossip-rounds "
                f"policy — cells share one staged gossip-product stream")

    p0 = built[0][1]
    x0_spec = pytree.tree_structure(p0.x0)
    x0_keys = [_leaf_key(leaf) for leaf in pytree.tree_leaves(p0.x0)]
    data_spec = pytree.tree_structure(p0.full_data)
    data0 = pytree.tree_leaves(p0.full_data)
    for i, (_, p) in enumerate(built[1:], 1):
        if pytree.tree_structure(p.x0) != x0_spec or \
                [_leaf_key(leaf) for leaf in pytree.tree_leaves(p.x0)] \
                != x0_keys:
            raise _ragged(f"cell {i} ({cells[i]}) changes the x0 pytree "
                          f"structure/shape")
        if pytree.tree_structure(p.full_data) != data_spec:
            raise _ragged(f"cell {i} ({cells[i]}) changes the dataset "
                          f"pytree structure")
        for a, b in zip(data0, pytree.tree_leaves(p.full_data)):
            if a is b:
                continue
            if a.shape != b.shape or a.device != b.device or \
                    not torch.equal(a, b):
                raise _ragged(
                    f"cell {i} ({cells[i]}) runs on a DIFFERENT dataset — "
                    f"the sweep shares one dataset among its cells")

    m0 = schedules[0].m
    for i, s in enumerate(schedules[1:], 1):
        if s.m != m0:
            raise _ragged(f"cell {i} ({cells[i]}) gossips over m={s.m} "
                          f"nodes vs m={m0} in cell 0")


def _require_traced(algo) -> None:
    meta = algo.meta
    needs_outer = (meta.outer_lengths is not None
                   or meta.snapshot_prob is not None)
    if not needs_outer:
        return
    needs_end = meta.outer_lengths is not None and algo.end_outer is not None
    if (algo.outer is not None and algo.outer_traced is None) or \
            (needs_end and algo.end_outer_traced is None):
        raise ValueError(
            f"{meta.name}: batched sweeps apply outer-round transitions to "
            f"all cells at once and need the traceable contract "
            f"(Algorithm.outer_traced"
            f"{' + end_outer_traced' if needs_end else ''}); run with "
            f"batched=False to sweep this algorithm sequentially")


# ---------------------------------------------------------------------------
# Every cell at once: torch.func.vmap over the cell axis
# ---------------------------------------------------------------------------

def _cell_values(cells: list, axis_names: list) -> dict:
    """The cells' values of each ``build`` axis as one host array: float32
    for real numbers (each cell rebuilds from a 0-d float32 tensor), the
    values' own type otherwise."""
    out = {}
    for name in axis_names:
        arr = np.asarray([c[name] for c in cells])
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def _over_cells(build: Callable, fn: Callable, tree, values: dict,
                args: tuple = (), arg_dims: tuple = ()):
    """``fn(algo, problem, tree, *args)`` for every cell at once:
    ``torch.func.vmap`` over the leading cell axis of ``tree``'s tensors
    and of ``values`` (each cell's ``build`` axis values), with each cell's
    algorithm and problem rebuilt from its own 0-d values.  Leaves of
    ``tree`` that are not tensors (an absent ``cstate``) pass through; the
    result's may be anything ``fn`` returns beside its tensors."""
    leaves, spec = pytree.tree_flatten(tree)
    live = [i for i, leaf in enumerate(leaves)
            if isinstance(leaf, torch.Tensor)]
    out_form: dict = {}

    def one_cell(tensors, cell, *a):
        full = list(leaves)
        for i, t in zip(live, tensors):
            full[i] = t
        algo, problem = build(**cell)
        out = fn(algo, problem, pytree.tree_unflatten(full, spec), *a)
        out_leaves, out_spec = pytree.tree_flatten(out)
        keep = [i for i, leaf in enumerate(out_leaves)
                if isinstance(leaf, torch.Tensor)]
        out_form.update(spec=out_spec, leaves=out_leaves, keep=keep)
        return [out_leaves[i] for i in keep]

    outs = torch.func.vmap(one_cell, in_dims=(0, 0) + tuple(arg_dims))(
        [leaves[i] for i in live], values, *args)
    full = list(out_form["leaves"])
    for i, t in zip(out_form["keep"], outs):
        full[i] = t
    return pytree.tree_unflatten(full, out_form["spec"])


def _piece_body(build, kernel: str, data_dev, values: dict,
                has_batch: bool, phi_batched: bool, sampler=None):
    """``body(state, xs, length) -> state`` of a batched sweep: ``length``
    staged steps of every cell, their minibatches gathered in one take per
    leaf (with a ``sampler``, drawn first from the staged step numbers,
    every cell from its own key), each cell's step under one vmap over the
    cells."""
    def run_steps(algo, problem, state, batches, phis, alphas, length):
        step_fn = runner_lib._resolve_kernel_step(algo, kernel)
        for j in range(length):
            b = pytree.tree_map(lambda a: a[j], batches) if has_batch \
                else None
            phi = runner_lib._step_slice(phis, j)
            state = step_fn(state, b, phi, alphas[j])
        return state

    def body(state, xs, length: int):
        idx, phis, alphas = xs
        if has_batch and sampler is not None:
            idx = sampler(idx)
        batches = (runner_lib.gather_batches(data_dev, idx) if has_batch
                   else None)
        # a None leaf of the phis (no straggler mask) is mapped over by no
        # axis
        phi_dims = (pytree.tree_map(lambda a: None if a is None else 1, phis)
                    if phi_batched else None)
        return _over_cells(
            build, lambda a, p, s, b, ph, al: run_steps(a, p, s, b, ph, al,
                                                        length),
            state, values, (batches, phis, alphas),
            (1 if has_batch else None, phi_dims, 1))

    return body


def _each_cell(built: list, fn: Callable, tree, which=None):
    """``fn(algo, problem, cell_tree)`` for each cell in ``which`` (every
    cell by default), one cell at a time with the cell's own algorithm and
    problem, and the cells restacked; the cells not in ``which`` keep their
    slice of ``tree``.  The transitions and records run so, and not under a
    vmap over the cells: there PyTorch's batching rule for a product of the
    shared dataset with the cells' iterates (a full gradient, an objective)
    copies the dataset once per cell."""
    which = range(len(built)) if which is None else which
    out = []
    for c, (algo, problem) in enumerate(built):
        sub = pytree.tree_map(
            lambda leaf: leaf[c] if isinstance(leaf, torch.Tensor) else leaf,
            tree)
        out.append(fn(algo, problem, sub) if c in which else sub)
    return _stack(out)


def _exec_chunk(state, chunk, xs, built, data_dev, run_piece):
    """Run one staged chunk of every cell piece by piece, applying the
    outer transitions between pieces where the host-side flags say: a new
    round or its end to every cell, a coin-flip refresh to the cells that
    flipped at that step."""
    o_pre, o_post, e_post, e_k = chunk.flags

    def outer(algo, problem, s):
        return algo.outer_traced(s, data_dev)

    for start, length in runner_lib._pieces(chunk):
        last = start + length - 1
        if o_pre[start]:
            state = _each_cell(built, outer, state)
        state = run_piece(state, runner_lib._slice(xs, start, start + length),
                          length)
        if o_post.ndim == 2 and o_post[last].any():
            state = _each_cell(built, outer, state,
                               which=set(np.flatnonzero(o_post[last])))
        if e_post[last]:
            k = float(e_k[last])
            state = _each_cell(
                built, lambda a, p, s: a.end_outer_traced(s, k), state)
    return state


def _stack(trees: list):
    return pytree.tree_map(
        lambda *ls: torch.stack(ls) if isinstance(ls[0], torch.Tensor)
        else ls[0], *trees)


# ---------------------------------------------------------------------------
# The sweep driver
# ---------------------------------------------------------------------------

def run_sweep(build: Callable,
              grid: dict,
              schedule=None,
              exec: "ExecSpec | None" = None,
              *,
              seed: int = 0,
              record_every: int = 1,
              batched: "bool | None" = None,
              mode: str = "product") -> SweepResult:
    """Run ``build(**cell)`` over every cell of ``grid``.

    build:     cell factory ``build(**cell) -> (Algorithm, Problem)``;
               called once per cell with the values themselves, and again
               in each piece of steps with 0-d tensor values.
    grid:      ``{axis: values}``; ``"seed"`` and ``"schedule"`` are driver
               axes (not passed to ``build``), every other axis is numeric.
               ``mode="product"`` (default) takes the cartesian product,
               ``"zip"`` pairs the axes up.
    schedule:  the shared mixing schedule, or put a ``"schedule"`` axis in
               the grid.  An ``ExecSpec`` passed here is taken as ``exec``.
    exec:      the :class:`ExecSpec`; ``None`` is ``ExecSpec(resident=
               True)``, the batched run on the CUDA device: one staging
               step, the chunks' pieces as vmapped steps of every cell (CUDA
               graphs on the card), one history pull for the whole grid.
               ``resident=False`` runs the cells through the host loop, one
               after another.  ``gossip`` and ``kernel`` behave as in
               ``runner.run``; every cell shares one transport.  The
               problems' tensors must lie on ``exec.device``.
    batched:   ``False`` with ``resident=True`` runs the cells as
               sequential resident runs, the baseline of the batched run.
    """
    if isinstance(schedule, ExecSpec):
        if exec is not None:
            raise TypeError("run_sweep got two ExecSpecs — one in the "
                            "schedule slot and one as exec=")
        schedule, exec = None, schedule
    spec = ExecSpec(resident=True) if exec is None else exec
    if not isinstance(spec, ExecSpec):
        raise TypeError(f"run_sweep: exec must be an ExecSpec, got "
                        f"{type(spec).__name__}")

    cells = expand_grid(grid, mode)
    axis_names = [n for n in grid if n not in _RESERVED_AXES]
    seeds = [c.get("seed", seed) for c in cells]
    schedules = [c.get("schedule", schedule) for c in cells]
    if any(s is None for s in schedules):
        raise ValueError("run_sweep needs a schedule: pass schedule= or a "
                         "'schedule' grid axis")
    if batched is None:
        batched = spec.resident
    if batched and not spec.resident:
        raise ValueError("batched sweeps are device-resident by "
                         "construction; resident=False implies "
                         "batched=False")
    if spec.shard == "nodes":
        raise ValueError("shard='nodes' partitions a single resident run's "
                         "node axis — use runner.run; batched sweeps "
                         "partition the CELL axis (shard='cells')")
    if spec.shard == "cells" and not batched:
        raise ValueError("shard='cells' partitions the batched cell axis "
                         "over the mesh; it requires batched=True (the "
                         "default)")

    def build_cell(cell):
        out = build(**{k: v for k, v in cell.items()
                       if k not in _RESERVED_AXES})
        if not (isinstance(out, tuple) and len(out) == 2):
            raise TypeError("build(**cell) must return (Algorithm, "
                            f"Problem), got {type(out).__name__}")
        return out

    built = [build_cell(c) for c in cells]
    _validate_cells(cells, built, schedules)
    if not batched:
        return _run_sequential(built, cells, schedules, seeds,
                               record_every=record_every, spec=spec)
    if spec.shard == "cells":
        return _run_cells_sharded(build, built, cells, schedules, seeds,
                                  axis_names, record_every=record_every,
                                  spec=spec)
    return _run_batched(build, built, cells, schedules, seeds, axis_names,
                        record_every=record_every, spec=spec)


def _cells_axis(mesh, B: int) -> spmd.NodeAxis:
    """This rank's block of the B cells over the mesh's ``"cells"`` dim
    (a fresh 1-D ``("cells",)`` mesh over every rank without one)."""
    if mesh is None:
        spmd.require_group("shard='cells'")
        mesh = spmd.world_mesh("cells")
    size = spmd.mesh_shape(mesh).get("cells")
    if size is None:
        raise ValueError(f"shard='cells' needs a mesh dim named 'cells'; "
                         f"got {spmd.mesh_shape(mesh)}")
    if B % size:
        raise ValueError(
            f"shard='cells': the {B}-cell grid must split evenly over the "
            f"'cells' mesh axis of size {size}; pad the grid (e.g. repeat "
            f"a seed) or pass a mesh whose cells axis divides it")
    return spmd.node_axis(mesh, "cells", B)


def _mesh_collective(backend) -> bool:
    """Whether a transport exchanges over a node axis of ranks (the
    ``ppermute`` family, possibly wrapped)."""
    if getattr(backend, "name", "") == "ppermute":
        return True
    inner = getattr(backend, "inner", None)
    if inner is None:
        return False
    if isinstance(inner, str):
        return inner == "ppermute"
    return _mesh_collective(inner)


def _run_cells_sharded(build, built, cells, schedules, seeds, axis_names, *,
                       record_every: int, spec: ExecSpec) -> SweepResult:
    """This rank's contiguous slice of the grid as the batched program,
    then every rank's histories, wire columns and parameters gathered in
    grid order."""
    backend = runner_lib._resolved_backend(spec.gossip, schedules[0],
                                           built[0][0].meta)
    if _mesh_collective(backend):
        raise ValueError(
            f"shard='cells' partitions the CELL axis over the mesh, but the "
            f"{backend.name!r} transport mixes through node-axis exchanges "
            f"between ranks; the two claim the same ranks.  Use "
            f"gossip='dense' or 'banded' (the mix stays within each rank's "
            f"grid slice), or shard='nodes' on a single run")
    ax = _cells_axis(spec.mesh, len(cells))
    mine = ax.rows
    part = _run_batched(build, built[mine], cells[mine], schedules[mine],
                        seeds[mine], axis_names, record_every=record_every,
                        spec=spec.replace(shard=None, mesh=None))
    columns = spmd.all_gather_object(
        ({f: np.asarray(getattr(part.history, f))
          for f in runner_lib.RunHistory._fields},
         np.asarray(part.extras["wire_bytes"])), ax.group)
    history = runner_lib.RunHistory(
        **{f: np.concatenate([c[0][f] for c in columns], axis=1)
           for f in runner_lib.RunHistory._fields})
    params = pytree.tree_map(lambda x: spmd.all_gather_rows(x, ax),
                             part.params)
    extras = dict(part.extras)
    extras["wire_bytes"] = np.concatenate([c[1] for c in columns], axis=1)
    extras["wire"] = spmd.wire_name(ax.group,
                                    pytree.tree_leaves(params)[0].device)
    return SweepResult(grid=cells, params=params, history=history,
                       extras=extras)


def _run_batched(build, built, cells, schedules, seeds, axis_names, *,
                 record_every: int, spec: ExecSpec) -> SweepResult:
    template_algo, template_problem = built[0]
    meta0 = template_algo.meta
    _require_traced(template_algo)
    device = runner_lib._resolve_device(spec)
    for _, problem in built:
        runner_lib._check_on_device(problem, device)
    backend = runner_lib._resolved_backend(spec.gossip, schedules[0], meta0,
                                           spec.mesh)
    aux_by_sched: dict = {}
    auxes = []
    for s in schedules:
        aux = aux_by_sched.get(id(s))
        if aux is None:
            aux = aux_by_sched[id(s)] = backend.prepare(s, meta0,
                                                        mesh=spec.mesh)
        auxes.append(aux)
    if transport.mesh_aux(auxes[0]) is not None:
        raise ValueError(
            f"the {backend.name!r} transport exchanges each node's row "
            f"between ranks, which a batched sweep cannot carry (its cells "
            f"step under one vmap); run the cells one by one "
            f"(batched=False) or through runner.run")

    m = pytree.tree_leaves(template_problem.x0)[0].shape[0]
    n = pytree.tree_leaves(template_problem.full_data)[0].shape[1]
    param_count = transport.node_param_count(template_problem.x0)
    has_batch = meta0.batch_size > 0
    device_sampling = has_batch and spec.sampling == "device"
    B = len(cells)
    transfers = {"h2d": 0, "d2h": 0}

    with span("sweep.plan"):
        rngs = [np.random.default_rng(s) for s in seeds]
        # one device stream a cell, its key drawn where a sequential run
        # draws it: first, before the plan
        keys = [int(r.integers(0, 2**31 - 1)) for r in rngs] \
            if device_sampling else None
        plan = runner_lib._plan_resident(
            [runner_lib._PlanCell(algo.meta, rng, backend, aux)
             for (algo, _), rng, aux in zip(built, rngs, auxes)],
            m=m, n=n, param_count=param_count, record_every=record_every,
            transitions=True, batched=True, device_sampling=device_sampling)
        host_values = _cell_values(cells, axis_names)

    # the dataset already lies on the device, shared by every cell: only
    # the plan and the cells' values are staged
    data_dev = template_problem.full_data
    with span("sweep.stage"):
        staged = runner_lib._stage(plan.chunks, device)
        values = {k: torch.from_numpy(v).to(device)
                  for k, v in host_values.items()}
        sampler = None
        if device_sampling:
            sampler = device_sampling_lib.IndexStream(
                keys, m=m, bsz=meta0.batch_size, n=n, device=device)
    transfers["h2d"] += 1                  # ONE staging step

    states = []
    for (algo, _), aux in zip(built, auxes):
        state = runner_lib.inject_mix_state(algo, backend, aux, algo.init())
        if algo.device_state is not None:
            state = algo.device_state(state)
        states.append(state)
    state = _stack(states)

    run_piece, piece_graphs = runner_lib._piece_runner(
        device, _piece_body(build, spec.kernel, data_dev, values, has_batch,
                            plan.phi_batched, sampler))
    get_params = template_algo.get_params
    track = meta0.track_consensus
    with span("sweep.execute"):
        bufs = torch.zeros((2, plan.num_records, B), dtype=torch.float32,
                           device=device)      # objective, consensus
        slot = 0
        for op in plan.ops:
            if op[0] == "chunk":
                state = _exec_chunk(state, plan.chunks[op[1]],
                                    staged[op[1]], built, data_dev,
                                    run_piece)
            else:                                # ("record",)
                params = get_params(state)
                bufs[0, slot] = _each_cell(
                    built, lambda a, p, prm: runner_lib._resolved_objective(
                        a.meta, p)(prm, data_dev), params)
                if track:
                    bufs[1, slot] = torch.func.vmap(
                        runner_lib.traceable_consensus)(params)
                slot += 1

    with span("sweep.pull"):
        history_buf = bufs.cpu().numpy()         # the ONE history pull
    transfers["d2h"] += 1

    history = runner_lib.RunHistory(
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
    return SweepResult(grid=cells, params=get_params(state), history=history,
                       extras=extras)


def _run_sequential(built, cells, schedules, seeds, *, record_every: int,
                    spec: ExecSpec) -> SweepResult:
    """The cells one after another, one ``runner.run`` each, stacked to the
    batched run's (records, cells) result."""
    results = [runner_lib.run(algo, problem, sched, spec, seed=s,
                              record_every=record_every)
               for (algo, problem), sched, s in zip(built, schedules, seeds)]
    lens = {len(r.history.steps) for r in results}
    if len(lens) > 1:
        raise _ragged(f"cells produced different record counts {lens}")
    history = runner_lib.RunHistory(
        **{f: np.stack([np.asarray(getattr(r.history, f))
                        for r in results], axis=1)
           for f in runner_lib.RunHistory._fields})
    extras = {
        "wire_bytes": np.stack(
            [np.asarray(r.extras["wire_bytes"]) for r in results], axis=1),
        "transfers_h2d": sum(int(r.extras["transfers_h2d"])
                             for r in results),
        "transfers_d2h": sum(int(r.extras["transfers_d2h"])
                             for r in results),
    }
    if spec.resident:
        for key in ("graphs_built", "replays"):
            extras[key] = sum(int(r.extras[key]) for r in results)
        extras["capture_s"] = sum(r.extras["capture_s"] for r in results)
    return SweepResult(grid=cells, params=_stack([r.params for r in results]),
                       history=history, extras=extras)
