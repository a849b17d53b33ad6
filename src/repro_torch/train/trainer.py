"""Decentralized LM training: the port of ``repro.train.trainer``
(``train_loop`` and ``train_sweep``) on one device.

``train_loop`` drives ``build_train_step`` with the paper's outer/inner
structure (a snapshot, the large-batch full-gradient refresh, every
``snapshot_every`` steps; multi-consensus gossip matrices from a
time-varying schedule) along two execution paths that share every step
function:

* **host loop** (default): the reference semantics, one batch and one phi
  copied to the device per step.  Accepts an :class:`~repro_torch.data.
  loader.LMLoader` or any legacy batch iterator.
* **resident** (``ExecSpec(resident=True)``, LMLoader only): the run is
  planned on the host like the reference's (windows cut at log and
  checkpoint boundaries, per-step window starts drawn from the loader's
  ``np.random`` stream in the host loop's order, phis and realized
  alphas), and staged with the ``(m, shard_len)`` token shards in ONE
  host-to-device step.  The steps then gather their minibatch windows from
  the resident shards with index operations on the device and run the
  snapshot refreshes at the steps the plan names; metrics are pulled once
  per log window.  ``hist["transfers"]`` counts what the reference's
  ledger counts: one staging transfer, one pull per record window, one
  per checkpoint.  The steps run eagerly.  ``sampling="device"`` draws
  the window starts on the device instead (``core.device_sampling``, the
  minibatch and the snapshot windows from two streams of one key derived
  from ``tc.seed``): the plan stages step numbers, nothing of the loader's
  stream is drawn, and a run repeats bitwise from its seed.

Periodic and final checkpoints (``ckpt_dir``/``ckpt_every``/``keep_last``)
capture the whole train state plus the loader's data cursor in the JAX
package's format, and ``resume=True`` continues from
``checkpoint.latest_step`` bitwise as the uninterrupted run would, on both
paths (same TrainerConfig).  A checkpoint of either package resumes in
the other, except one written with device sampling: its ``"key"`` leaf
names the writer's stream (a ``jax.random`` key, or the port's key as a
(1,) int64 array), and the streams differ, so each package refuses the
other's.

``train_sweep`` trains a λ/α grid as one resident program: one shared
loader stream, staged once, every cell's node-vmapped step under one
``torch.func.vmap`` over the cells, one metrics pull.

Across ranks (SPMD over ``torch.distributed``, ``core.spmd``: every rank
makes the same call with the same loader and gets the same history back):
``train_loop(mesh=, plan=)`` shards the state on the host loop
(``steps.build_train_step``: the node axis over the plan's node dims, each
leaf a DTensor over the others; ``final_state`` holds each rank's shards,
``TrainBundle.gather`` makes them whole), and ``train_sweep(exec=
ExecSpec(shard="cells", mesh=))`` splits the grid's cells over the mesh's
``"cells"`` dim, as ``core.sweep.run_sweep`` does.  The reference's
refusals stand: sharded state on the resident path, ``shard="nodes"`` and
``shard="cells"`` in ``train_loop``, ``shard="nodes"`` in
``train_sweep``.  A sharded run checkpoints in the same format as one
device, the reference's "resharding restore": every rank takes part in
gathering the state whole (``TrainBundle.gather``, a leaf at a time),
rank 0 alone writes (the format is single-writer: its atomic rename and
``keep_last`` pruning), and the others wait for it at a barrier; on
``resume=True`` every rank reads the checkpoint and keeps its rows and
shards (``TrainBundle.place``), so a checkpoint written on one layout
resumes on any other of the same ``m``, or on one device.

Refused, by name: ``kernel`` other than ``"plain"`` (as the reference
refuses other than ``"xla"``), and configs that route the forward through
the RMSNorm or flash kernels, which have no backward.

Under ``torch.profiler``, ``train_loop``'s parts are spans of the same
names on both paths (``repro_torch.spans``): ``train.build`` (the bundle,
the transport, the state), ``train.plan`` (resident only), ``train.stage``
(the resident path's one copy; the host loop's batch and phi a step),
``train.refresh``, ``train.step`` (its ``train.grad`` and ``train.mix``),
``train.record`` and ``train.ckpt``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import checkpoint as ckpt_lib
from ..core import algorithm as algo_lib, graphs, prox as prox_lib, \
    runner as runner_lib, schedules, spmd, sweep as sweep_lib, transport
from ..core.device_sampling import IndexStream, trainer_key
from ..core.exec_spec import ExecSpec
from ..data import loader as loader_lib
from ..models.api import ModelConfig
from ..models.common import resolve_device
from ..spans import span
from . import steps as steps_lib
from .tracker import CompositeTracker, HistoryTracker, resolve_tracker

__all__ = ["TrainerConfig", "train_loop", "train_sweep"]

# the metadata mark of a checkpoint whose "key" leaf holds the port's
# device stream (a jax.random key is a (2,) uint32 array; the port's key a
# (1,) int64 one, so the reference's restore refuses it by its shape)
DEVICE_STREAM = "repro_torch.device_sampling"


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 200
    snapshot_every: int = 50        # production K (fixed)
    snapshot_batch_mult: int = 4    # "full" gradient ~ mult x minibatch (loader paths)
    alpha: float = 0.05
    consensus_rounds: int = 2       # capped multi-consensus
    algorithm: str = "dpsvrg"       # core.algorithm.UPDATE_RULES name (or an UpdateRule)
    gossip: str = "auto"            # transport.GOSSIP_BACKENDS name / instance / "auto"
    lr_schedule: str = "constant"   # constant | wsd | cosine
    log_every: int = 10
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    keep_last: int | None = None    # retention: prune all but the N newest ckpts
    seed: int = 0
    resident: bool = False          # device-resident execution (LMLoader data)
    sampling: str = "host"          # "host" | "device" (resident only)
    tracker: Any = None             # tracker spec (see tracker.resolve_tracker)


def _lr_fn(tc: TrainerConfig):
    if tc.lr_schedule == "wsd":
        return schedules.wsd(tc.alpha, warmup=max(tc.num_steps // 20, 1),
                             stable=int(tc.num_steps * 0.75),
                             decay=max(tc.num_steps // 5, 1))
    if tc.lr_schedule == "cosine":
        return schedules.warmup_cosine(tc.alpha, max(tc.num_steps // 20, 1),
                                       tc.num_steps)
    return schedules.constant(tc.alpha)


def _realized_alpha_fn(tc: TrainerConfig, rule):
    """The step size the update ACTUALLY uses (recorded in metrics).

    VR-type rules (snapshot-corrected) take the configured LR schedule;
    plain stochastic rules need the DSPG decaying step to converge — a
    configured non-constant schedule would be silently ignored, so warn
    loudly instead."""
    if rule.needs_snapshot:
        return _lr_fn(tc)
    if tc.lr_schedule != "constant":
        warnings.warn(
            f"TrainerConfig.lr_schedule={tc.lr_schedule!r} is OVERRIDDEN for "
            f"the non-variance-reduced {rule.name!r} rule, which requires "
            f"the decaying DSPG step alpha0/(k+1)^0.5 to converge; the "
            f"realized step size is recorded in the 'alpha' metric column",
            RuntimeWarning, stacklevel=3)
    return schedules.dspg_stepsize(tc.alpha)


def _check_lm_spec(spec: ExecSpec, caller: str) -> None:
    """The LM trainer consumes the SAME ExecSpec as ``runner.run`` but only
    implements the host-loop / resident halves of it; fields that select
    logistic-regression-only machinery fail loudly instead of being
    ignored."""
    if spec.scan:
        raise ValueError(f"{caller}: the LM trainer has no scan path — "
                         f"ExecSpec(scan=True) selects runner.run's "
                         f"compiled chunk path; use resident=True here")
    if spec.kernel != "plain":
        raise ValueError(f"{caller}: ExecSpec(kernel={spec.kernel!r}) "
                         f"selects the fused resident step of runner.run; "
                         f"the LM trainer's kernels come from the model "
                         f"config")
    if spec.device_transitions is False:
        raise ValueError(f"{caller}: the resident LM path always runs "
                         f"snapshot refreshes at the steps its plan names; "
                         f"device_transitions=False applies to runner.run")


def _check_trainable(cfg: ModelConfig, caller: str) -> None:
    if cfg.use_flash or cfg.use_fused_norm:
        raise ValueError(
            f"{caller}: {cfg.name} has use_flash={cfg.use_flash}, "
            f"use_fused_norm={cfg.use_fused_norm}: the flash attention and "
            f"RMSNorm kernels have no backward (nor have the JAX package's "
            f"Pallas kernels); train with both off (cfg.scaled(use_flash="
            f"False, use_fused_norm=False)) and serve with them on")


def _check_device_stream(ckpt_dir: str) -> None:
    """Refuse to continue a device-sampled run from a checkpoint whose
    ``"key"`` leaf is not the port's stream."""
    _, step, md = ckpt_lib.restore(ckpt_dir, {})
    if md.get("device_stream") != DEVICE_STREAM:
        raise ValueError(
            f"resume with sampling='device': the checkpoint at step {step} "
            f"under {ckpt_dir} holds no key of the port's device stream "
            f"(written by the JAX package, whose key is a jax.random key, "
            f"or with host sampling).  The two packages' device streams "
            f"differ, so the run cannot continue bitwise; resume it with "
            f"the package and sampling that wrote it")


def _to(device, tree, dtype=None):
    """Tree leaves (numpy arrays or tensors; None kept) as tensors on
    ``device``, cast to ``dtype`` where given."""
    return pytree.tree_map(
        lambda a: None if a is None
        else torch.as_tensor(a).to(device=device, dtype=dtype), tree)


def _mix_fields(mix) -> tuple:
    """The fields of a transport state (``TrainState.mix_state``), each a
    tree of the rank's local shards shaped as the params (a
    ``CompressionState``'s error feedback); () for a stateless transport."""
    return () if mix is None else mix._fields


def _save_sharded(ckpt_dir: str, step: int, bundle, state, md: dict,
                  keep_last) -> None:
    """A sharded state's checkpoint in the one-device format: each leaf is
    gathered whole on rank 0's host in turn (``bundle.gather(dst=0)``),
    while a thread of rank 0 writes the leaves gathered before it; every
    rank waits for the write at a barrier."""
    mix = state.mix_state
    placed_tree = {"params": state.params, "snapshot": state.snapshot,
                   "full_grad": state.full_grad}
    if mix is not None:
        placed_tree["mix_state"] = {f: pytree.tree_map(
            steps_lib._rewrap, state.params, getattr(mix, f))
            for f in _mix_fields(mix)}
    leaves = pytree.tree_leaves(placed_tree)
    if spmd.dist.get_rank() != 0:
        for x in leaves:
            bundle.gather(x, dst=0)
        spmd.dist.barrier()
        return
    futures = [concurrent.futures.Future() for _ in leaves]
    whole = pytree.tree_unflatten(futures,
                                  pytree.tree_structure(placed_tree))
    if mix is not None:
        whole["mix_state"] = mix._replace(**whole["mix_state"])
    tree = {"state": state._replace(
        params=whole["params"], snapshot=whole["snapshot"],
        full_grad=whole["full_grad"], step=state.step.cpu(),
        mix_state=whole.get("mix_state"))}
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        writing = pool.submit(ckpt_lib.save, ckpt_dir, step, tree, md,
                              keep_last=keep_last)
        try:
            for x, future in zip(leaves, futures):
                future.set_result(bundle.gather(x, dst=0))
        except BaseException as exc:     # the writer must not wait forever
            for future in futures:
                if not future.done():
                    future.set_exception(exc)
            raise
        finally:
            del tree, whole
        writing.result()
    spmd.dist.barrier()


def _restore_sharded(ckpt_dir: str, bundle, mix, cfg, m: int, device):
    """The latest checkpoint under ``ckpt_dir`` (written by one device or by
    any layout of ``m`` nodes) as this rank's sharded state: every rank
    reads its rows of it (``bundle.rows``) a field at a time and moves its
    shards of them to its device (``bundle.place``); ``mix`` is the run's
    fresh transport state (None when stateless).  Returns (state,
    metadata)."""
    shapes = steps_lib.make_stacked_init(cfg, m)(0, "meta")
    empty = steps_lib.TrainState(params=None, snapshot=None, full_grad=None,
                                 step=None)
    wanted = {"params": shapes, "snapshot": shapes, "full_grad": shapes,
              "step": torch.zeros((), dtype=torch.int32)}
    if mix is not None:
        wanted["mix_state"] = mix._replace(
            **{f: shapes for f in _mix_fields(mix)})
    fields = {}
    for f, template in wanted.items():
        tree, _, md = ckpt_lib.restore(
            ckpt_dir, {"state": empty._replace(**{f: template})},
            rows=bundle.rows)
        got = getattr(tree["state"], f)
        del tree
        if f == "step":
            fields[f] = _to(device, got)
        elif f == "mix_state":
            fields[f] = got._replace(**{g: pytree.tree_map(
                steps_lib._local, bundle.place(getattr(got, g)))
                for g in _mix_fields(mix)})
        else:
            fields[f] = bundle.place(got)
        del got
    return steps_lib.TrainState(**fields), md


def gather_windows(shards: torch.Tensor, starts: torch.Tensor,
                   window: torch.Tensor) -> dict:
    """Minibatch windows gathered on the shards' device: ``shards`` (m,
    shard_len), ``starts`` (m, B) int64, ``window`` ``arange(seq_len + 1)``
    -> ``{"tokens", "labels"}`` (m, B, seq_len), element for element what
    ``LMLoader.gather`` gives for the same starts."""
    idx = starts[:, :, None] + window                     # (m, B, L + 1)
    win = torch.take_along_dim(shards[:, None, :], idx, dim=2)
    return {"tokens": win[..., :-1], "labels": win[..., 1:]}


class _Window(NamedTuple):
    """One stretch of the resident plan, ending at a record or checkpoint
    step or at the run's last step."""
    length: int             # steps in this window
    last_step: int          # absolute index of its last step
    record: bool            # pull the metrics and log after it
    ckpt_next: int | None   # checkpoint step number to save, or None
    alpha_last: float       # realized alpha at last_step
    wire_end: int           # cumulative wire bytes after it
    slot_end: int           # gossip slot cursor after it
    loader_state: Any       # loader cursor AT this boundary (checkpoint
    #                         windows only: planning draws the whole run's
    #                         starts first, so the live state_dict at save
    #                         time would be the end-of-run cursor)


def train_loop(cfg: ModelConfig,
               prox: prox_lib.Prox,
               schedule: graphs.MixingSchedule,
               data,
               tc: TrainerConfig,
               snapshot_batch_iter=None,
               mesh=None, plan=None,
               exec: "ExecSpec | None" = None, *,
               tracker=None,
               resume: bool = False) -> dict:
    """Returns the history dict (``step``/``loss``/``v_norm``/``alpha``/
    ``wire_bytes``/``time`` columns, plus ``final_state`` and the
    ``transfers`` ledger).

    ``data`` is an :class:`~repro_torch.data.loader.LMLoader` (both
    execution paths, resume support, loader-stream snapshot batches of
    ``per_node_batch * snapshot_batch_mult`` windows) or a legacy iterator
    of stacked per-node batch dicts (host path only;
    ``snapshot_batch_iter`` then supplies the outer-loop refresh batches,
    defaulting to ``data``).

    ``exec`` is the :class:`~repro_torch.core.exec_spec.ExecSpec`
    ``runner.run`` consumes; ``None`` is ``ExecSpec(resident=tc.resident,
    sampling=tc.sampling)``, which runs on the CUDA device (pass
    ``ExecSpec(device="cpu")`` for the CPU).  Its ``gossip`` overrides
    ``tc.gossip`` unless it is ``"auto"``.  ``tracker`` falls back to
    ``tc.tracker``."""
    spec = ExecSpec(resident=tc.resident, sampling=tc.sampling) \
        if exec is None else exec
    if not isinstance(spec, ExecSpec):
        raise TypeError(f"train_loop: exec must be an ExecSpec, got "
                        f"{type(spec).__name__}")
    _check_lm_spec(spec, "train_loop")
    if spec.shard == "cells":
        raise ValueError("shard='cells' partitions a hyperparameter grid's "
                         "cell axis — use train_sweep for batched λ/lr "
                         "grids; train_loop drives a single configuration")
    if spec.shard == "nodes":
        raise ValueError("the resident LM path does not support sharded "
                         "state (shard='nodes') yet — use the host loop "
                         "with mesh/plan")
    _check_trainable(cfg, "train_loop")
    resident = spec.resident
    if mesh is None:
        mesh = spec.mesh
    gossip = tc.gossip if spec.gossip == "auto" else spec.gossip

    m = schedule.m
    rule = algo_lib.UPDATE_RULES[tc.algorithm] \
        if isinstance(tc.algorithm, str) else tc.algorithm
    vr = rule.needs_snapshot
    alpha_fn = _realized_alpha_fn(tc, rule)

    is_loader = isinstance(data, loader_lib.LMLoader)
    if resident and not is_loader:
        raise ValueError(
            "resident=True plans the whole run up front, which needs the "
            "LMLoader's index-based sampling — pass the loader itself, not "
            "a batch iterator")
    if resident and (mesh is not None or plan is not None):
        raise ValueError("the resident LM path does not support sharded "
                         "state (mesh/plan) yet — use the host loop")
    if resume and not (tc.ckpt_dir and is_loader):
        raise ValueError("resume=True needs ckpt_dir and an LMLoader (the "
                         "checkpoint stores the loader's data cursor)")
    if is_loader and snapshot_batch_iter is not None:
        raise ValueError(
            "snapshot_batch_iter is not supported with an LMLoader: both "
            "execution paths draw snapshot batches from the loader's own "
            "stream (per_node_batch * snapshot_batch_mult windows) — pass a "
            "legacy batch iterator as `data` to control snapshot batches")
    device_sampling = resident and spec.sampling == "device"
    with span("train.build"):
        bundle = steps_lib.build_train_step(cfg, prox, m, plan=plan,
                                            mesh=mesh, algorithm=rule)
        device = resolve_device(spec.device)

        # the transport backend owns the wire format: its per-step phi
        # flows into the train step, which dispatches the mix on its type;
        # stateful transports thread their state via TrainState.mix_state.
        # A sharded run's transport sees the node dim only (ppermute takes
        # it when it has one node a rank)
        node_mesh = None if mesh is None else \
            steps_lib.node_layout(mesh, plan, m).node_mesh
        tmeta = transport.TransportMeta.constant(tc.consensus_rounds)
        backend = transport.resolve_backend(gossip, schedule, tmeta,
                                            node_mesh)
        gaux = backend.prepare(schedule, tmeta, mesh=node_mesh)

        state = bundle.init_state(tc.seed, device)
        if backend.needs_mix_state:
            # the mix runs on each rank's local shards, and so does its
            # state
            state = state._replace(mix_state=backend.init_mix_state(
                gaux, pytree.tree_map(steps_lib._local, state.params)))
    param_count = transport.node_param_count(state.params)
    # the device stream's key: the stream's whole state, beside the step
    key = trainer_key(tc.seed) if device_sampling else None

    transfers = {"h2d": 0, "d2h": 0}
    start_step, slot, wire = 0, 0, 0
    if resume:
        template = {"state": state}
        if device_sampling:
            _check_device_stream(tc.ckpt_dir)
            template["key"] = torch.zeros(1, dtype=torch.int64)
        if mesh is None:
            tree, _, md = ckpt_lib.restore(tc.ckpt_dir, template)
            state = None             # free the fresh state before the copy
            state = _to(device, tree["state"])
        else:
            mix, state = state.mix_state, None
            state, md = _restore_sharded(tc.ckpt_dir, bundle, mix, cfg, m,
                                         device)
        if device_sampling:
            key = int(tree["key"][0])
        transfers["h2d"] += 1
        start_step = int(md["step"])
        slot = int(md["slot"])
        wire = int(md["wire"])
        if md.get("loader") is not None:
            data.load_state_dict(md["loader"])

    history = HistoryTracker()
    track = CompositeTracker(
        [history] + resolve_tracker(tracker if tracker is not None
                                    else tc.tracker))

    t0 = time.time()

    def record(step: int, loss, v_norm, alpha, wire_now: int):
        track.log_metrics({"loss": float(loss), "v_norm": float(v_norm),
                           "alpha": float(alpha), "wire_bytes": wire_now,
                           "time": time.time() - t0}, step=step)

    def is_record(step: int) -> bool:
        return step % tc.log_every == 0 or step == tc.num_steps - 1

    def is_ckpt(step: int) -> bool:
        return bool(tc.ckpt_dir and tc.ckpt_every
                    and (step + 1) % tc.ckpt_every == 0)

    def save_ckpt(cur_state, next_step: int, *, slot_at: int | None = None,
                  wire_at: int | None = None,
                  loader_state: dict | None = None):
        """Write a resumable checkpoint.  The host loop's live ``slot``/
        ``wire``/loader cursor ARE the values at the save point; the
        resident path plans (and so advances all three to end-of-run)
        before executing, so its periodic saves pass the boundary values
        explicitly."""
        with span("train.ckpt"):
            transfers["d2h"] += 1
            if loader_state is None and is_loader:
                loader_state = data.state_dict()
            md = {"step": next_step,
                  "slot": slot if slot_at is None else slot_at,
                  "wire": wire if wire_at is None else wire_at,
                  "algorithm": rule.name,
                  "loader": loader_state}
            if mesh is not None:
                _save_sharded(tc.ckpt_dir, next_step, bundle, cur_state, md,
                              tc.keep_last)
                return
            tree = {"state": cur_state}
            if device_sampling:
                tree["key"] = torch.tensor([key], dtype=torch.int64)
                md["device_stream"] = DEVICE_STREAM
            ckpt_lib.save(tc.ckpt_dir, next_step, tree, md,
                          keep_last=tc.keep_last)

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------
    if not resident:
        if is_loader:
            def next_batch():
                t, l = data.sample()
                return {"tokens": t, "labels": l}

            def next_big():
                starts = data.sample_starts(
                    data.per_node_batch * tc.snapshot_batch_mult)
                t, l = data.gather(starts)
                return {"tokens": t, "labels": l}
        else:
            batch_it = iter(data)
            snap_it = iter(snapshot_batch_iter) if snapshot_batch_iter \
                is not None else batch_it
            next_batch = lambda: next(batch_it)
            next_big = lambda: next(snap_it)

        for step in range(start_step, tc.num_steps):
            if vr and step % tc.snapshot_every == 0:
                with span("train.refresh"):
                    big = _to(device, next_big())
                    # the refresh replaces the snapshot and the full
                    # gradient: let the old ones go first, so that their
                    # memory (two copies of the stacked parameters) is free
                    # while the large batch's activations are held, the
                    # run's peak
                    state = state._replace(snapshot=None, full_grad=None)
                    state = bundle.snapshot_step(state, big)
            phi = backend.phi_for(gaux, slot, tc.consensus_rounds)
            wire += backend.bytes_per_step(gaux, phi, param_count)
            slot += tc.consensus_rounds
            with span("train.stage"):
                batch = _to(device, next_batch())
                phi = _to(device, phi, torch.float32)
            transfers["h2d"] += 1      # per-step batch/phi staging
            alpha = alpha_fn(step)
            with span("train.step"):
                state, metrics = bundle.train_step(
                    state, batch, phi, float(np.float32(alpha)))
            if is_record(step):
                with span("train.record"):
                    record(step, metrics["loss"], metrics["v_norm"], alpha,
                           wire)
                transfers["d2h"] += 1
            if is_ckpt(step):
                save_ckpt(state, step + 1)
    # ------------------------------------------------------------------
    # resident path: plan -> stage once -> steps gather on the device
    # ------------------------------------------------------------------
    else:
        B = data.per_node_batch
        snap_B = B * tc.snapshot_batch_mult
        with span("train.plan"):
            windows: list[_Window] = []
            starts, sstarts, snaps, phis, alphas = [], [], [], [], []
            count = 0
            for step in range(start_step, tc.num_steps):
                snap = vr and step % tc.snapshot_every == 0
                # draw order matches the host loop exactly: snapshot
                # windows first (when refreshing), then the minibatch;
                # device sampling draws nothing here
                if snap and not device_sampling:
                    sstarts.append(data.sample_starts(snap_B))
                snaps.append(snap)
                if not device_sampling:
                    starts.append(data.sample_starts(B))
                phi = backend.phi_for(gaux, slot, tc.consensus_rounds)
                wire += backend.bytes_per_step(gaux, phi, param_count)
                slot += tc.consensus_rounds
                phis.append(phi)
                alpha = alpha_fn(step)
                alphas.append(alpha)
                count += 1
                if is_record(step) or is_ckpt(step) or \
                        step == tc.num_steps - 1:
                    windows.append(_Window(
                        length=count, last_step=step,
                        record=is_record(step),
                        ckpt_next=step + 1 if is_ckpt(step) else None,
                        alpha_last=alpha, wire_end=wire, slot_end=slot,
                        loader_state=data.state_dict() if is_ckpt(step)
                        else None))
                    count = 0

        # ONE staging transfer ships the plan and the token shards (with
        # device sampling, the steps' numbers in place of their starts);
        # nothing per step crosses the host boundary thereafter
        with span("train.stage"):
            staged = _to(device, (
                data.stacked_shards(),
                np.asarray(starts, np.int64).reshape(len(starts), m, B),
                np.asarray(sstarts, np.int64).reshape(len(sstarts), m,
                                                      snap_B),
                np.arange(start_step, tc.num_steps, dtype=np.int64)
                if device_sampling else None,
                runner_lib._stack_wire(phis) if phis else None,
                np.asarray(alphas, np.float32)))
        transfers["h2d"] += 1
        shards, starts_dev, sstarts_dev, steps_dev, phis_dev, alphas_dev = \
            staged
        window = torch.arange(data.seq_len + 1, device=device)
        if device_sampling:
            # two streams of the one key: minibatch and snapshot windows
            draw = IndexStream(key, m=m, bsz=B, n=data.max_start,
                               device=device)
            draw_snap = IndexStream(key, m=m, bsz=snap_B, n=data.max_start,
                                    device=device, stream=1)

        t = r = 0
        for w in windows:
            for _ in range(w.length):
                if snaps[t]:
                    with span("train.refresh"):
                        sst = (draw_snap(steps_dev[t:t + 1])[0]
                               if device_sampling else sstarts_dev[r])
                        # the old snapshot and full gradient go first, as
                        # in the host loop
                        state = state._replace(snapshot=None,
                                               full_grad=None)
                        state = bundle.snapshot_step(
                            state, gather_windows(shards, sst, window))
                    r += 1
                with span("train.step"):
                    st = (draw(steps_dev[t:t + 1])[0] if device_sampling
                          else starts_dev[t])
                    state, metrics = bundle.train_step(
                        state, gather_windows(shards, st, window),
                        pytree.tree_map(lambda a: a[t], phis_dev),
                        alphas_dev[t])
                t += 1
            if w.record:
                with span("train.record"):
                    loss, v_norm = torch.stack(
                        [metrics["loss"], metrics["v_norm"]]).tolist()
                    record(w.last_step, loss, v_norm, w.alpha_last,
                           w.wire_end)
                transfers["d2h"] += 1        # one pull per window
            if w.ckpt_next is not None:
                save_ckpt(state, w.ckpt_next, slot_at=w.slot_end,
                          wire_at=w.wire_end, loader_state=w.loader_state)

    # final checkpoint (skipped when the periodic cadence just wrote it)
    if tc.ckpt_dir and start_step < tc.num_steps and \
            not (tc.ckpt_every and tc.num_steps % tc.ckpt_every == 0):
        save_ckpt(state, tc.num_steps)

    losses = history.history().get("loss", [])
    track.log_summary({
        "algorithm": rule.name, "steps": tc.num_steps,
        "resident": resident, "sampling": spec.sampling,
        "final_loss": losses[-1] if losses else None,
        "wire_bytes": wire, "wall_time": time.time() - t0,
        "transfers": dict(transfers),
    })
    track.finish()

    hist = history.history()
    hist["final_state"] = state
    hist["transfers"] = dict(transfers)
    if mesh is not None:
        hist["wire"] = spmd.wire_name(
            steps_lib.node_layout(mesh, plan, m).axis.group, device)
    return hist


# ---------------------------------------------------------------------------
# Batched λ/α-grid sweeps: the whole grid as one resident program
# ---------------------------------------------------------------------------

def train_sweep(cfg: ModelConfig,
                build,
                schedule: graphs.MixingSchedule,
                data,
                tc: TrainerConfig,
                grid: dict,
                exec: "ExecSpec | None" = None,
                mode: str = "product") -> dict:
    """Train a whole hyperparameter grid as ONE resident program.

    ``build(**cell) -> Prox`` is the cell factory (``prox.l1(lam)``, ...),
    called once per cell with the values themselves (validation) and again
    in every step under ``torch.func.vmap`` over the cells with each value a
    0-d float32 tensor, so each cell computes its own regularizer.  ``grid``
    maps axis names to value lists (``mode`` ``"product"`` or ``"zip"``);
    the reserved axis ``"alpha"`` is the driver's: it overrides
    ``tc.alpha`` in the cell's realized step-size schedule (staged as a
    ``(steps, cells)`` column) and is not passed to ``build``.

    Every cell sees the SAME loader stream ``data``, drawn once on the host
    in ``train_loop``'s planning order, so cell i's history equals a
    sequential ``train_loop(exec=ExecSpec(resident=True))`` over a fresh
    same-seed loader to float tolerance.  The plan, the token shards and
    the cells' values ship in one staging transfer; each step gathers its
    windows on the device and runs every cell's node-vmapped step under one
    vmap over the cells (rebuilding each cell's ``Prox`` from its values,
    as ``core.sweep`` does); the snapshot refreshes run at the steps the
    plan names, cell by cell, since a refresh does not depend on the cell's
    prox and its large batch's activations would otherwise scale with the
    cells; one ``(2, steps, cells)`` pull of the losses and ``v_norm`` ends
    the run.  Like ``train_loop`` it runs eagerly, without CUDA graphs or
    kernels.  ``exec`` defaults to ``ExecSpec(resident=True)`` (on the CUDA
    device).

    Returns ``{"grid", "step", "loss", "v_norm", "alpha", "wire_bytes",
    "time", "final_state", "transfers"}`` with ``(records, cells)`` metric
    columns and the cell axis in front of every state leaf.
    """
    spec = ExecSpec(resident=True) if exec is None else exec
    if not isinstance(spec, ExecSpec):
        raise TypeError(f"train_sweep: exec must be an ExecSpec, got "
                        f"{type(spec).__name__}")
    _check_lm_spec(spec, "train_sweep")
    if not spec.resident:
        raise ValueError("train_sweep is a batched device-resident program "
                         "(the grid rides one vmapped step); for sequential "
                         "cells loop train_loop")
    if spec.sampling != "host":
        raise ValueError("train_sweep stages ONE shared host-drawn loader "
                         "stream so every cell sees the draws a sequential "
                         "train_loop would; sampling='device' is not "
                         "supported")
    if tc.ckpt_dir or tc.tracker:
        raise ValueError("train_sweep neither checkpoints nor streams "
                         "trackers — run cells through train_loop for "
                         "those")
    if spec.shard == "nodes":
        raise ValueError("shard='nodes' partitions a single run's node "
                         "axis — train_sweep partitions the CELL axis "
                         "(shard='cells')")
    if not isinstance(data, loader_lib.LMLoader):
        raise ValueError("train_sweep plans the whole run up front, which "
                         "needs the LMLoader's index-based sampling")
    _check_trainable(cfg, "train_sweep")
    gossip = tc.gossip if spec.gossip == "auto" else spec.gossip
    device = resolve_device(spec.device)

    cells = sweep_lib.expand_grid(grid, mode)
    n_cells = len(cells)
    if spec.shard == "cells":
        return _sweep_cells_sharded(cfg, build, schedule, data, tc, cells,
                                    spec, gossip)
    if spec.mesh is not None:
        raise ValueError("train_sweep takes a mesh with shard='cells' only "
                         "(the cells split over its \"cells\" dim)")
    axis_names = [n for n in grid if n != "alpha"]
    m = schedule.m
    rule = algo_lib.UPDATE_RULES[tc.algorithm] \
        if isinstance(tc.algorithm, str) else tc.algorithm
    vr = rule.needs_snapshot
    alpha_fns = [_realized_alpha_fn(
        dataclasses.replace(tc, alpha=float(c.get("alpha", tc.alpha))), rule)
        for c in cells]

    def cell_prox(cell):
        out = build(**{k: v for k, v in cell.items() if k != "alpha"})
        if not isinstance(out, prox_lib.Prox):
            raise TypeError(f"build(**cell) must return a Prox, got "
                            f"{type(out).__name__}")
        return out

    proxes = [cell_prox(c) for c in cells]   # the concrete validation pass

    tmeta = transport.TransportMeta.constant(tc.consensus_rounds)
    backend = transport.resolve_backend(gossip, schedule, tmeta)
    gaux = backend.prepare(schedule, tmeta)
    bundle0 = steps_lib.build_train_step(cfg, proxes[0], m, algorithm=rule)
    state0 = bundle0.init_state(tc.seed, device)
    if backend.needs_mix_state:
        state0 = state0._replace(
            mix_state=backend.init_mix_state(gaux, state0.params))
    param_count = transport.node_param_count(state0.params)

    # the host's plan: ONE shared draw stream and phi schedule, in
    # train_loop's order (snapshot windows first, then the minibatch), and
    # each cell's realized alphas as a (steps, cells) column
    B = data.per_node_batch
    snap_B = B * tc.snapshot_batch_mult
    starts, sstarts, snaps, phis, wires = [], [], [], [], []
    alphas = np.empty((tc.num_steps, n_cells), np.float32)
    slot = wire = 0
    for step in range(tc.num_steps):
        snap = vr and step % tc.snapshot_every == 0
        if snap:
            sstarts.append(data.sample_starts(snap_B))
        snaps.append(snap)
        starts.append(data.sample_starts(B))
        phi = backend.phi_for(gaux, slot, tc.consensus_rounds)
        wire += backend.bytes_per_step(gaux, phi, param_count)
        slot += tc.consensus_rounds
        phis.append(phi)
        wires.append(wire)
        for j, fn in enumerate(alpha_fns):
            alphas[step, j] = fn(step)

    transfers = {"h2d": 0, "d2h": 0}
    staged = _to(device, (
        data.stacked_shards(),
        np.asarray(starts, np.int64).reshape(len(starts), m, B),
        np.asarray(sstarts, np.int64).reshape(len(sstarts), m, snap_B),
        runner_lib._stack_wire(phis),
        alphas,
        sweep_lib._cell_values(cells, axis_names)))
    transfers["h2d"] += 1                      # ONE staging transfer
    shards, starts_dev, sstarts_dev, phis_dev, alphas_dev, values = staged
    window = torch.arange(data.seq_len + 1, device=device)

    # every cell starts from the same state; the snapshot aliases the
    # parameters until the first refresh replaces both
    def per_cell(leaf):
        return None if leaf is None else \
            leaf.expand((n_cells,) + leaf.shape).clone()

    state = state0._replace(
        params=pytree.tree_map(per_cell, state0.params),
        full_grad=pytree.tree_map(per_cell, state0.full_grad),
        step=per_cell(state0.step),
        mix_state=pytree.tree_map(per_cell, state0.mix_state))
    state = state._replace(snapshot=state.params)
    del state0

    def cell_step(prox_t, _, state_c, batch, phi, alpha):
        bundle_t = steps_lib._build_train_step(cfg, prox_t, m, rule)
        return bundle_t.train_step(state_c, batch, phi, alpha)

    def refresh(state, big):
        """Every cell's snapshot refresh, one cell at a time, each cell's
        full gradient written into one (cells, m, ...) buffer."""
        params = state.params
        full = pytree.tree_map(torch.empty_like, params)
        state = state._replace(snapshot=None, full_grad=None)
        for c in range(n_cells):
            cell = steps_lib.TrainState(
                params=pytree.tree_map(lambda a: a[c], params),
                snapshot=None, full_grad=None, step=state.step[c])
            mu = bundle0.snapshot_step(cell, big).full_grad
            pytree.tree_map(lambda out, g: out[c].copy_(g), full, mu)
            del mu
        return state._replace(snapshot=params, full_grad=full)

    t0 = time.time()
    mbuf = torch.zeros((2, tc.num_steps, n_cells), dtype=torch.float32,
                       device=device)
    r = 0
    for t in range(tc.num_steps):
        if snaps[t]:
            state = refresh(state, gather_windows(shards, sstarts_dev[r],
                                                  window))
            r += 1
        state, mets = sweep_lib._over_cells(
            lambda **cell: (cell_prox(cell), None), cell_step, state, values,
            (gather_windows(shards, starts_dev[t], window),
             pytree.tree_map(lambda a: a[t], phis_dev), alphas_dev[t]),
            (None, None, 0))
        mbuf[0, t] = mets["loss"]
        mbuf[1, t] = mets["v_norm"]
    losses, vnorms = mbuf.cpu().numpy()        # the ONE metrics pull
    transfers["d2h"] += 1

    rec = [s for s in range(tc.num_steps)
           if s % tc.log_every == 0 or s == tc.num_steps - 1]
    return {
        "grid": cells,
        "step": rec,
        "loss": np.asarray(losses, np.float64)[rec],
        "v_norm": np.asarray(vnorms, np.float64)[rec],
        "alpha": alphas[rec],
        "wire_bytes": [wires[s] for s in rec],
        "time": time.time() - t0,
        "final_state": state,
        "transfers": dict(transfers),
    }


def _sweep_cells_sharded(cfg, build, schedule, data, tc, cells, spec,
                         gossip) -> dict:
    """``train_sweep`` with its cells split over the mesh's ``"cells"``
    dim: each rank runs its contiguous slice of the grid as the batched
    program (every rank draws the same loader stream), then every rank's
    columns and final states are gathered in grid order."""
    backend = transport.resolve_backend(
        gossip, schedule, transport.TransportMeta.constant(
            tc.consensus_rounds))
    if sweep_lib._mesh_collective(backend):
        raise ValueError(
            f"shard='cells' partitions the CELL axis over the mesh, but "
            f"the {backend.name!r} transport mixes through node-axis mesh "
            f"collectives — use gossip='dense' or 'banded'")
    ax = sweep_lib._cells_axis(spec.mesh, len(cells))
    mine = cells[ax.rows]
    part = train_sweep(cfg, build, schedule, data, tc,
                       {k: [c[k] for c in mine] for k in cells[0]},
                       exec=spec.replace(shard=None, mesh=None), mode="zip")
    columns = spmd.all_gather_object(
        {k: np.asarray(part[k]) for k in ("loss", "v_norm", "alpha")},
        ax.group)
    out = dict(part, grid=cells, **{
        k: np.concatenate([c[k] for c in columns], axis=1)
        for k in ("loss", "v_norm", "alpha")})
    out["final_state"] = pytree.tree_map(
        lambda x: None if x is None else spmd.all_gather_rows(x, ax),
        part["final_state"])
    out["wire"] = spmd.wire_name(ax.group, resolve_device(spec.device))
    return out
