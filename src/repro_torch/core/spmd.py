"""Runs over several processes: the port's counterpart of the reference's
device meshes (``jax.sharding.Mesh`` under GSPMD, ``shard_map`` around
``lax.ppermute``).

The reference is one controller over a mesh of devices.  Its counterpart
here is one process a rank, SPMD over ``torch.distributed``: every rank
makes the same entry-point call (``runner.run``, ``sweep.run_sweep``,
``scenarios.run_matrix``) and gets the same result back.  What crosses
ranks goes through this module, and nowhere else:

* **The mesh** is a ``torch.distributed.device_mesh.DeviceMesh`` with named
  dims (``ExecSpec(mesh=...)``); :func:`mesh_shape` gives its ``{name:
  size}``, the reference's ``mesh.shape``.  Without one, a run that needs a
  mesh builds a 1-D one over the default group (:func:`world_mesh`), and
  raises without an initialized group, naming :func:`spawn`.
* **A node axis** (:class:`NodeAxis`) is a mesh dim, or several flattened
  into one (:func:`node_mesh`), that splits the ``m`` nodes in contiguous
  blocks, ``m / size`` rows a rank.  A node-sharded run holds only its rows
  of every ``(m, ...)`` leaf.
* **The wire**: :func:`shift` (one point-to-point exchange a band: rank
  ``j`` sends to ``(j - d) % size`` and receives from ``(j + d) % size``,
  the reference's ``ppermute``), :func:`all_gather_rows`,
  :func:`all_reduce_sum` and :func:`all_gather_object`.  The group's
  backend sets the wire, reported by runs as ``extras["wire"]``
  (:func:`wire_name`): ``"nccl"`` (a card a rank), ``"gloo"`` (CPU tensors)
  or ``"gloo-host-staged"`` (CUDA tensors of ranks that share a card, which
  NCCL refuses: each exchange is copied through host buffers, explicitly).
  No wire falls back to another: NCCL over fewer cards than ranks raises
  (:func:`check_backend`); :func:`backend_for` picks NCCL where each
  rank has a card, gloo otherwise.
* **Placed tensors** (``torch.distributed.tensor``, the LM path's sharded
  weights) exchange through PyTorch's functional collectives.  Over gloo
  their CUDA implementations crash the rank, so on ranks that share a
  card :func:`stage_placed_collectives` reroutes them through host
  buffers on the same gloo group (the ``gloo-host-staged`` wire, by name):
  each collective copies its operand to the host, runs the plain gloo
  collective there and copies the result back, before it returns.
* **Launching**: :func:`spawn` starts ``world`` fresh processes, joins them
  through a ``file://`` store in a temporary directory (no port to clash
  on), runs a module-level function in each and returns each rank's result,
  with a timeout on the whole group.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import multiprocessing
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

__all__ = ["WIRES", "require_group", "backend_for", "check_backend",
           "world_mesh",
           "mesh_shape", "NodeAxis", "node_mesh", "node_axis", "wire_name",
           "shift",
           "all_gather_rows", "all_reduce_sum", "all_gather_object",
           "local_problem", "stage_placed_collectives", "placed_wire",
           "spawn"]

WIRES = ("nccl", "gloo", "gloo-host-staged")


def require_group(what: str) -> None:
    """Raise unless a default process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} runs across processes, one a rank, and needs an "
            f"initialized default process group; start the ranks with "
            f"repro_torch.core.spmd.spawn(fn, world, backend=...) (or "
            f"torch.distributed.init_process_group) and make the same call "
            f"on every rank")


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def backend_for(device, world: int) -> str:
    """The backend for ``world`` ranks on ``device``: NCCL with a card a
    rank, else gloo (host-staged between ranks that share a card, plain on
    the CPU)."""
    if torch.device(device).type == "cuda" and _cards() >= world:
        return "nccl"
    return "gloo"


def check_backend(backend: str, world: int) -> None:
    """Refuse a backend that cannot carry ``world`` ranks on this host:
    NCCL needs a card a rank (it refuses two ranks of one communicator on
    one card)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl":
        cards = _cards()
        if cards < world:
            raise ValueError(
                f"NCCL needs a card a rank, but {world} ranks were asked "
                f"for and {cards} card(s) are visible; ranks that share a "
                f"card run over gloo, host-staged (backend='gloo', "
                f"device='cuda')")


def world_mesh(name: str):
    """A 1-D mesh named ``name`` over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh
    require_group(f"a {name!r} mesh")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(name,))


def mesh_shape(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` (the reference's
    ``mesh.shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims need names (mesh_dim_names=...)")
    return dict(zip(names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class NodeAxis:
    """This rank's block of ``m`` nodes split over mesh dim ``axis``:
    ``rows`` (a slice) of the node axis, ``size`` ranks on the axis,
    ``index`` this rank's place among them, ``ranks`` their global ranks
    in axis order."""
    mesh: Any
    axis: str
    m: int
    group: Any
    size: int
    index: int
    ranks: tuple

    @property
    def rows(self) -> slice:
        per = self.m // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def peer(self, index: int) -> int:
        """The global rank at ``index`` (mod size) on the axis."""
        return self.ranks[index % self.size]


@functools.lru_cache(maxsize=32)
def node_mesh(mesh, axes):
    """The 1-D mesh of ``mesh``'s dims ``axes`` (a name or a tuple of
    names): ``mesh[axis]`` for one dim; for several, their ranks flattened
    row-major in the order of ``axes`` (the first dim major, the order of
    the reference's ``P(("pod", "data"))``) into one dim named
    ``"_".join(axes)``, over the ranks that share every other coordinate
    with this one.  Building it creates process groups, which every rank
    of the world does in the same order: every rank makes the same call
    (``DeviceMesh``'s constructor over the rank tensor with the other dims
    first and the node dims flattened last)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh dims {missing} are not dims of the mesh "
                         f"{names}")
    if len(axes) == 1:
        return mesh[axes[0]]
    from torch.distributed.device_mesh import DeviceMesh
    node_dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in node_dims]
    size = 1
    for i in node_dims:
        size *= mesh.mesh.shape[i]
    ranks = mesh.mesh.permute(rest + node_dims).reshape(-1, size)
    name = "_".join(axes)
    if not rest:
        return DeviceMesh(mesh.device_type, ranks[0],
                          mesh_dim_names=(name,))
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("_".join(names[i] for i in rest),
                                      name))[name]


@functools.lru_cache(maxsize=32)
def node_axis(mesh, axis, m: int) -> NodeAxis:
    """The :class:`NodeAxis` of ``m`` nodes over ``mesh``'s dim ``axis``,
    whose size must divide ``m``.  ``axis`` may be a tuple of dims: the
    nodes then lie over their product, a rank's index row-major over them
    in the tuple's order (:func:`node_mesh`), and the axis is that of the
    flattened 1-D mesh (its ``mesh`` and ``axis`` name it)."""
    if not isinstance(axis, str):
        flat = node_mesh(mesh, tuple(axis))
        return node_axis(flat, flat.mesh_dim_names[0], m)
    size = mesh_shape(mesh)[axis]
    if m % size:
        raise ValueError(f"{m} nodes do not split evenly over the {size} "
                         f"ranks of mesh dim {axis!r}")
    group = mesh.get_group(axis)
    return NodeAxis(mesh, axis, m, group, size, mesh.get_local_rank(axis),
                    tuple(dist.get_process_group_ranks(group)))


def wire_name(group, device) -> str:
    """The wire a group's exchanges of tensors on ``device`` take."""
    if dist.get_backend(group) == "nccl":
        return "nccl"
    return "gloo-host-staged" if torch.device(device).type == "cuda" \
        else "gloo"


def _outbound(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if wire_name(group, x.device) == "gloo-host-staged":
        return x.cpu()
    return x


def shift(x: torch.Tensor, shifts, ax: NodeAxis) -> list:
    """For each ``d`` in ``shifts``: the ``x`` of the rank ``(index + d) %
    size`` places along the axis, while this rank's ``x`` goes to ``(index
    - d) % size`` (the reference's ``ppermute`` with ``perm = [(j, (j - d)
    % m)]``).  One batch of point-to-point exchanges for all shifts."""
    send = _outbound(x, ax.group)
    bufs = [torch.empty_like(send) for _ in shifts]
    ops = []
    for d, buf in zip(shifts, bufs):
        ops.append(dist.P2POp(dist.isend, send, ax.peer(ax.index - d),
                              ax.group))
        ops.append(dist.P2POp(dist.irecv, buf, ax.peer(ax.index + d),
                              ax.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(x.device) for b in bufs]


def all_gather_rows(x: torch.Tensor, ax: NodeAxis) -> torch.Tensor:
    """Every rank's rows of the node axis, concatenated in axis order:
    ``(m, ...)`` from each rank's ``(m / size, ...)``."""
    send = _outbound(x, ax.group)
    parts = [torch.empty_like(send) for _ in range(ax.size)]
    dist.all_gather(parts, send, group=ax.group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor on ``x``'s
    device)."""
    buf = _outbound(x, group).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather_object(obj, group=None) -> list:
    """Every rank's ``obj`` (host data), in group rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# The functional collectives of placed tensors, host-staged over gloo
# ---------------------------------------------------------------------------

_STAGED: dict = {}     # dispatch key -> the torch.library holding the impls


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _on_host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().cpu()


def _reduced(x: torch.Tensor, op: str, name) -> torch.Tensor:
    """The reduction of ``x`` over the group (a new host tensor); gloo has
    no average, so ``"avg"`` is the sum over the group's size."""
    group = _group(name)
    buf = _on_host(x).clone()
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}
    dist.all_reduce(buf, op=ops[op.lower()], group=group)
    return buf / dist.get_world_size(group) if op.lower() == "avg" else buf


def _staged_all_gather(x, group_size, name):
    out = torch.empty((group_size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype)
    dist.all_gather_into_tensor(out, _on_host(x), group=_group(name))
    return out.to(x.device)


def _staged_all_reduce(x, op, name):
    return _reduced(x, op, name).to(x.device)


def _staged_all_reduce_(x, op, name):
    return x.copy_(_reduced(x, op, name))


def _staged_reduce_scatter(x, op, group_size, name):
    index = dist.get_rank(_group(name))
    return _reduced(x, op, name).chunk(group_size)[index].to(x.device)


def _staged_all_to_all(x, out_splits, in_splits, name):
    rows = sum(out_splits) if out_splits else x.shape[0]
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype)
    dist.all_to_all_single(out, _on_host(x), list(out_splits) or None,
                           list(in_splits) or None, group=_group(name))
    return out.to(x.device)


def stage_placed_collectives(device_type: str = "cuda") -> None:
    """Route the functional collectives of tensors on ``device_type``
    (``_c10d_functional``'s all-gather, all-reduce, reduce-scatter and
    all-to-all, what DTensor's redistributions call) through host buffers
    on their gloo group: each runs the plain collective on host copies and
    returns the result on the operand's device, done (its wait is a
    no-op).  Once a process; the ranks of a card shared over gloo install
    it for ``"cuda"`` (:func:`placed_wire`)."""
    if device_type in _STAGED:
        return
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for op, fn in (("all_gather_into_tensor", _staged_all_gather),
                   ("all_reduce", _staged_all_reduce),
                   ("all_reduce_", _staged_all_reduce_),
                   ("reduce_scatter_tensor", _staged_reduce_scatter),
                   ("all_to_all_single", _staged_all_to_all),
                   ("all_gather_into_tensor_coalesced",
                    lambda xs, n, name: [_staged_all_gather(x, n, name)
                                         for x in xs]),
                   ("reduce_scatter_tensor_coalesced",
                    lambda xs, op, n, name: [
                        _staged_reduce_scatter(x, op, n, name) for x in xs]),
                   ("all_reduce_coalesced",
                    lambda xs, op, name: [_staged_all_reduce(x, op, name)
                                          for x in xs])):
        lib.impl(op, fn, key)
    _STAGED[device_type] = lib


def placed_wire(mesh) -> str:
    """The wire of a mesh's placed tensors: ``"nccl"``, ``"gloo"`` (CPU
    tensors) or ``"gloo-host-staged"`` (a CUDA mesh over gloo: ranks that
    share a card), installing the staged collectives for the last."""
    wire = wire_name(mesh.get_group(0), mesh.device_type)
    if wire == "gloo-host-staged":
        stage_placed_collectives("cuda")
    return wire


def local_problem(problem, mesh=None, axis: str = "nodes"):
    """``problem`` (an ``algorithm.Problem`` whose ``x0`` and
    ``full_data`` lead with the ``m`` nodes) cut to this rank's rows of
    ``mesh``'s dim ``axis`` (by default a 1-D ``("nodes",)`` mesh over the
    default group).  Each rank of a node-sharded run builds its algorithm
    on its cut problem and passes both to ``runner.run``."""
    m = pytree.tree_leaves(problem.x0)[0].shape[0]
    if mesh is None:
        mesh = world_mesh(axis)
    rows = node_axis(mesh, axis, m).rows
    cut = lambda tree: pytree.tree_map(lambda a: a[rows], tree)  # noqa
    return problem._replace(x0=cut(problem.x0),
                            full_data=cut(problem.full_data))


# ---------------------------------------------------------------------------
# spawn: one process a rank
# ---------------------------------------------------------------------------

def _host(tree):
    """Tensors to numpy arrays, so a rank's result pickles as plain data."""
    return pytree.tree_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else a, tree)


def _rank_main(rank: int, world: int, backend: str, device: str, store: str,
               fn: Callable, args: tuple, timeout: float, out) -> None:
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        else:                        # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
            device_id=(torch.device("cuda", rank) if backend == "nccl"
                       else None))
        out.put((rank, True, _host(fn(*args))))
    except BaseException:  # reported to the parent, which raises
        # before the group goes: its peers then fail in turn
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(out, rank: int, payload: str, fn: Callable) -> str:
    """The first failed rank's traceback and those of the ranks that fail
    within a second after it (a failure makes its peers fail in turn, and
    the first to report need not be the cause), in rank order."""
    failed = {rank: payload}
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        try:
            r, ok, p = out.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue_lib.Empty:
            break
        if not ok:
            failed[r] = p
    return "\n".join(f"spmd.spawn: rank {r} of {fn.__name__} failed:\n{p}"
                     for r, p in sorted(failed.items()))


def spawn(fn: Callable, world: int, *, backend: str = "gloo",
          device: str = "cpu", args: tuple = (),
          timeout: float = 180.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks, one fresh process each, and
    return their results in rank order (tensors come back as numpy
    arrays).

    ``fn`` must be a module-level function (it is pickled by name; the
    module it lives in is imported in each rank).  Each rank initializes
    the default group over ``backend`` through a ``file://`` store in a
    temporary directory; with ``device="cuda"`` it makes its card current
    (card ``rank`` over NCCL; card 0, shared, over gloo), on the CPU it
    takes its share of the host's cores.  A rank that
    raises fails the call with its traceback, and a group not done within
    ``timeout`` seconds is killed and fails it too."""
    check_backend(backend, world)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spmd-")
    store = os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, backend, device, store, fn, args,
                               timeout, out), daemon=True)
             for rank in range(world)]
    results: dict = {}
    deadline = time.monotonic() + timeout
    done = False
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spmd.spawn: {world - len(results)} of {world} ranks "
                    f"of {fn.__name__} not done after {timeout:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if lost:
                    raise RuntimeError(
                        f"spmd.spawn: rank(s) {lost} of {fn.__name__} "
                        f"exited (codes {[procs[r].exitcode for r in lost]})"
                        f" without a result") from None
                continue
            if not ok:
                raise RuntimeError(_failures(out, rank, payload, fn))
            results[rank] = payload
        done = True
    finally:
        # after a failure the other ranks may wait in a collective: kill.
        # Only the processes that started can be joined: when a start
        # fails, its error is the one the caller gets
        for p in started:
            p.join(timeout=5.0 if done else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
