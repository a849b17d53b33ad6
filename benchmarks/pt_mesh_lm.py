"""The LM path across ranks at full width: the runs of ``chip_smoke.py``'s
phase 31 and the unsharded runs they are held to.

    python3 -c "import chip_smoke as c; c._build.build(c.SOURCES); \\
        c.mesh_lm_phase()"

h2o-danube-1.8b at full width (d 2560, 32 / 8 heads, d_ff 6912, vocab
32000) cut to ``LAYERS`` of its 24 layers, weights from a seed.  ``RANKS``
ranks (``core.spmd.spawn``) build the (data=2, model=2) mesh
(``launch.mesh.make_mesh``; the faithful plan: the m = ``M`` nodes over
data, each leaf a DTensor over model) and each run:

* ``trainer.train_loop(mesh=, plan=)`` on the host loop: a snapshot
  refresh and ``TRAIN_STEPS`` DPSVRG steps, the dense transport; each rank
  holds its final shards to the unsharded card run's (which this process
  runs first and leaves under ``build/phase31``);
* sharded serving (``steps.build_serve_steps(plan=, mesh=)``): a
  ``PROMPT``-token prefill and ``NEW`` greedy decode steps of 2 requests,
  the weights placed by the specs, one request a data rank, 16 / 4 heads
  a model rank; every launch count set to 0 before and read after: flash
  once a layer a prefill (on the rank's heads), RMSNorm 2 a layer and 1
  more a forward (on the rank's rows);
* the flash and RMSNorm kernels on random operands of a rank's shard
  shapes, against their plain versions;
* over NCCL, one more refresh and step under ``torch.profiler``, read by
  ``launch.roofline.collective_bytes`` (over gloo the ranks share a card
  and its collectives are host-staged, untraced, as in phase 30).

This process serves the same weights unsharded and holds the ranks'
tokens equal and their logits within ``LOGITS_TOL``, the trained
parameters within ``PARAMS_TOL`` and the losses within ``LOSS_TOL`` (the
bounds of the reference's own equivalence test), and the wire bytes
exactly.  Ranks sharing one card run over gloo, host-staged; with a card a
rank, over NCCL (``spmd.backend_for``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import pt_common as common
from repro_torch import configs
from repro_torch.core import graphs, prox, spmd
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data.loader import LMLoader
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops, ref as rn_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import placed, transformer
from repro_torch.train import steps, trainer

RANKS = 4
MESH_SHAPE, MESH_NAMES = (2, 2), ("data", "model")
PLAN = mesh_lib.PLANS[("single", "faithful")]
M = 2
LAYERS = 2
SEED = 0
LAM = 1e-4
TRAIN_STEPS = 4
PER_NODE_BATCH, SEQ = 2, 64
PROMPT, NEW, REQUESTS = 512, 8, 2
TIMEOUT = 600.0
PARAMS_TOL, LOSS_TOL = 5e-5, 1e-5      # test_eight_device_equivalence
LOGITS_TOL = 1e-3
KERNEL_TOL = dict(rtol=1e-5, atol=2e-5)
SMOKE = False          # the smoke variant's widths: a CPU rehearsal
TWIN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "phase31")


def config(serve: bool):
    """danube at full width, ``LAYERS`` layers; served through the
    kernels, trained on the plain path (the kernels have no backward)."""
    cfg = configs.get_config("h2o-danube-1.8b")
    if SMOKE:
        cfg = configs.smoke_variant(cfg)
    return cfg.scaled(num_layers=LAYERS, use_flash=serve,
                      use_fused_norm=serve)


def loader() -> LMLoader:
    tokens = np.random.default_rng(SEED).integers(
        0, config(False).vocab_size, size=M * 4 * SEQ)
    return LMLoader(tokens, num_nodes=M, per_node_batch=PER_NODE_BATCH,
                    seq_len=SEQ, seed=SEED)


def trainer_config(steps_: int = TRAIN_STEPS) -> trainer.TrainerConfig:
    return trainer.TrainerConfig(
        num_steps=steps_, snapshot_every=steps_, log_every=1, alpha=0.05,
        consensus_rounds=2, seed=SEED, gossip="dense")


def train(device, mesh=None, steps_: int = TRAIN_STEPS) -> dict:
    return trainer.train_loop(
        config(False), prox.l1(LAM),
        graphs.b_connected_ring_schedule(M, b=1, seed=0), loader(),
        trainer_config(steps_), mesh=mesh, plan=None if mesh is None
        else PLAN, exec=ExecSpec(device=device))


def prompts(device) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, config(True).vocab_size, size=(REQUESTS, PROMPT)), device=device)


def serve(device, mesh=None) -> dict:
    """A prefill of every request, then ``NEW`` greedy decode steps: the
    tokens and each step's logits, whole, and the seconds of each part."""
    cfg = config(True)
    bundle = steps.build_serve_steps(cfg, plan=None if mesh is None
                                     else PLAN, mesh=mesh)
    params = bundle.place_params(transformer.init_params(cfg, SEED, device))
    whole = lambda x: x.full_tensor() if placed.is_placed(x) else x  # noqa
    common.sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill_step(params, prompts(device),
                                        max_len=PROMPT + NEW)
    outs, toks = [whole(logits)], []
    common.sync(device)
    t1 = time.perf_counter()
    for _ in range(NEW):
        tok = torch.argmax(outs[-1], dim=-1)
        toks.append(tok)
        logits, cache = bundle.decode_step(params, cache, tok)
        outs.append(whole(logits))
    common.sync(device)
    return {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
            "logits": torch.stack(outs).cpu().numpy(),
            "prefill_s": t1 - t0,
            "decode_ms": (time.perf_counter() - t1) / NEW * 1e3}


def _row_slices(x, rows: slice) -> tuple:
    """The slices of the whole stacked leaf that the rank's shard ``x``
    (its rows of the node axis, a DTensor over the rest) holds."""
    if not placed.is_placed(x):
        return (rows,)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return (rows,) + tuple(slice(o, o + n) for o, n in
                           zip(offset[1:], shape[1:]))


def _vs_twin(params, rows: slice, path: str) -> float:
    """Largest difference of the rank's shards from the unsharded run's
    parameters saved under ``path``."""
    twin = torch.load(path, mmap=True, map_location="cpu")
    worst = 0.0
    for key, x in pytree.tree_flatten_with_path(params)[0]:
        want = twin[pytree.keystr(key)][_row_slices(x, rows)]
        got = (x.to_local() if placed.is_placed(x) else x).cpu()
        worst = max(worst, float((got - want).abs().max()))
    return worst


def _kernels_vs_plain(device) -> dict:
    """flash and RMSNorm on random operands of a rank's shard shapes (one
    request, 16 / 4 heads, the prompt's rows) against their plain
    versions; returns the max abs errors and the operands' shapes."""
    cfg = config(True)
    heads = cfg.num_heads // MESH_SHAPE[1]
    kv = cfg.num_kv_heads // MESH_SHAPE[1]
    gen = torch.Generator().manual_seed(spmd.dist.get_rank())
    q = torch.randn(1, PROMPT, heads, cfg.hd, generator=gen).to(device)
    k, v = (torch.randn(1, PROMPT, kv, cfg.hd, generator=gen).to(device)
            for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, causal=True,
                                 sliding_window=cfg.sliding_window)
    want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                sliding_window=cfg.sliding_window
                                ).transpose(1, 2)
    x = torch.randn(1, PROMPT, cfg.d_model, generator=gen).to(device)
    w = torch.randn(cfg.d_model, generator=gen).to(device)
    norm = rn_ops.rmsnorm(x, w)
    torch.testing.assert_close(out, want, **KERNEL_TOL)
    torch.testing.assert_close(norm, rn_ref.rmsnorm_ref(x, w),
                               **KERNEL_TOL)
    return {"flash": float((out - want).abs().max()),
            "rmsnorm": float((norm - rn_ref.rmsnorm_ref(x, w)).abs().max()),
            "flash_shape": list(q.shape), "rmsnorm_shape": list(x.shape)}


def _traced_step(device, mesh) -> dict:
    """Over NCCL: a refresh and one step under torch.profiler, the trace
    read by ``launch.roofline.collective_bytes``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import roofline
    if spmd.dist.get_backend() != "nccl":
        return {"traced": False}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        train(device, mesh, steps_=1)
        common.sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        coll = roofline.collective_bytes(
            path, group_size=spmd.dist.get_world_size())
    return {"traced": True, "collective_bytes": coll}


def rank_runs(device: str, twin_path: str, t_spawn: float,
              sizes: dict) -> dict:
    """Every run of the phase on this rank (``spmd.spawn`` starts the
    ranks; each makes the same calls) at the parent's ``sizes``."""
    globals().update(sizes)
    stage = {"entered": time.time() - t_spawn}
    mesh = mesh_lib.make_mesh(MESH_SHAPE, MESH_NAMES, device)
    layout = steps.node_layout(mesh, PLAN, M)
    common.sync(device)
    t0 = time.perf_counter()
    hist = train(device, mesh)
    common.sync(device)
    train_s = time.perf_counter() - t0
    stage["train"] = time.time() - t_spawn
    out = {"loss": np.asarray(hist["loss"]),
           "wire_bytes": np.asarray(hist["wire_bytes"]),
           "wire": hist["wire"], "placed_wire": layout.wire,
           "train_s": train_s,
           "params_vs_unsharded": _vs_twin(hist["final_state"].params,
                                           layout.axis.rows, twin_path)}
    del hist
    torch.cuda.empty_cache() if device == "cuda" else None
    fa_ops.launches = rn_ops.launches = 0
    out["serve"] = serve(device, mesh)
    out["launches"] = {"flash_attention": fa_ops.launches,
                       "rmsnorm": rn_ops.launches}
    stage["serve"] = time.time() - t_spawn
    out["kernels_vs_plain"] = _kernels_vs_plain(device)
    out["trace"] = _traced_step(device, mesh)
    stage["done"] = time.time() - t_spawn
    out["stage_s"] = stage
    if device == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def run(device="cuda", **sizes) -> dict:
    """Run the unsharded twins, spawn the ranks, hold one to the other;
    returns the phase's summary (raises on a mismatch).  ``sizes``
    overrides this module's sizes (``SMOKE``, ``LAYERS``, ``PROMPT``,
    ``NEW``, ``SEQ``) here and on the ranks: a CPU rehearsal."""
    globals().update(sizes)
    device = common.require_device(device)
    kind = device.type
    os.makedirs(TWIN_DIR, exist_ok=True)
    twin_path = os.path.join(TWIN_DIR, "params.pt")
    try:
        common.sync(device)
        t0 = time.perf_counter()
        twin = train(kind)
        common.sync(device)
        twin_train_s = time.perf_counter() - t0
        torch.save({pytree.keystr(k): v.cpu() for k, v in
                    pytree.tree_flatten_with_path(
                        twin["final_state"].params)[0]}, twin_path)
        twin = {k: twin[k] for k in ("loss", "wire_bytes")}
        if kind == "cuda":
            torch.cuda.empty_cache()
        backend = spmd.backend_for(device, RANKS)
        t0 = time.perf_counter()
        ranks = spmd.spawn(rank_runs, RANKS, backend=backend, device=kind,
                           args=(kind, twin_path, time.time(), sizes),
                           timeout=TIMEOUT)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(TWIN_DIR, ignore_errors=True)
    served = serve(kind)
    wire = "nccl" if backend == "nccl" else (
        "gloo-host-staged" if kind == "cuda" else "gloo")
    for rank, got in enumerate(ranks):
        if got["wire"] != wire or got["placed_wire"] != wire:
            raise AssertionError(f"rank {rank}: wire {got['wire']} / "
                                 f"{got['placed_wire']}, want {wire}")
        if got["params_vs_unsharded"] >= PARAMS_TOL:
            raise AssertionError(
                f"rank {rank}: trained params differ from the unsharded "
                f"run's by {got['params_vs_unsharded']}")
        np.testing.assert_allclose(got["loss"], twin["loss"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_array_equal(got["wire_bytes"], twin["wire_bytes"])
        np.testing.assert_array_equal(got["serve"]["tokens"],
                                      served["tokens"])
        np.testing.assert_allclose(got["serve"]["logits"], served["logits"],
                                   rtol=0, atol=LOGITS_TOL)
    r0 = ranks[0]
    return {
        "ranks": RANKS, "backend": backend, "wire": wire,
        "mesh": dict(zip(MESH_NAMES, MESH_SHAPE)), "m": M,
        "layers": LAYERS, "spawn_s": spawn_s, "rank0_stage_s": r0["stage_s"],
        "train_steps": TRAIN_STEPS,
        "sharded_train_s": [r["train_s"] for r in ranks],
        "unsharded_train_s": twin_train_s,
        "max_abs_params_vs_unsharded": max(
            r["params_vs_unsharded"] for r in ranks),
        "max_abs_loss_vs_unsharded": max(
            float(np.abs(r["loss"] - twin["loss"]).max()) for r in ranks),
        "wire_bytes": int(r0["wire_bytes"][-1]),
        "tokens_equal": True,
        "max_abs_logits_vs_unsharded": max(
            float(np.abs(r["serve"]["logits"] - served["logits"]).max())
            for r in ranks),
        "sharded_prefill_s": r0["serve"]["prefill_s"],
        "sharded_decode_ms": r0["serve"]["decode_ms"],
        "unsharded_prefill_s": served["prefill_s"],
        "unsharded_decode_ms": served["decode_ms"],
        "launches_per_rank": [r["launches"] for r in ranks],
        "kernels_vs_plain": r0["kernels_vs_plain"],
        "collective_bytes_per_rank": [
            r["trace"].get("collective_bytes") for r in ranks],
        "peak_bytes_per_rank": [r.get("peak_bytes", 0) for r in ranks],
    }
