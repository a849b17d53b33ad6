"""The LM path across ranks at full width: the runs of ``chip_smoke.py``'s
phase 31 and the unsharded runs they are held to.

    python3 -c "import chip_smoke as c; c._build.build(c.SOURCES); \\
        c.mesh_lm_phase()"

``RANKS`` ranks (``core.spmd.spawn``) run every part in one group; ranks
sharing one card run over gloo, host-staged, and with a card a rank over
NCCL (``spmd.backend_for``).  Weights come from a seed, and every part is
held to its unsharded twin, which this process runs on the same device
while the ranks work (publishing under ``TWIN_DIR`` what the ranks read,
holding the rest to what they return):

* **danube** (h2o-danube-1.8b at full width: d 2560, 32 / 8 heads, d_ff
  6912, vocab 32000) cut to ``LAYERS`` of its 24 layers, on the (data=2,
  model=2) mesh (the faithful plan: the m = ``M`` nodes over data, each
  leaf a DTensor over model): ``trainer.train_loop(mesh=, plan=)``, a
  snapshot refresh and ``TRAIN_STEPS`` DPSVRG steps (each rank's final
  shards within ``PARAMS_TOL`` of the twin's), then sharded serving, a
  ``PROMPT``-token prefill and ``NEW`` greedy decode steps of 2 requests
  (one a data rank, 16 / 4 heads a model rank) with every launch count
  set to 0 before and read after: flash once a layer a prefill (on the
  rank's heads), RMSNorm 2 a layer and 1 more a forward (on the rank's
  rows); the flash and RMSNorm kernels on random operands of a rank's
  shard shapes against their plain versions; over NCCL, one more refresh
  and step under ``torch.profiler`` (``launch.roofline.collective_bytes``);
* **(a) nodes over two mesh dims**: danube cut to ``MULTI_LAYERS`` layers
  under the reference's ("multi", "faithful") plan on a (pod=2, data=2,
  model=1) mesh, m = ``MULTI_M`` (a node a rank, row-major over pod and
  data), a refresh and ``MULTI_STEPS`` steps
  over the ppermute transport, held to the same run with the nodes over
  one dim (data=4, model=1): params within ``LAYOUT_TOL``, losses within
  ``LOSS_TOL``, wire bytes exact;
* **(b) checkpoints**: danube cut to ``CKPT_LAYERS`` layers on the (data=2,
  model=2) mesh, ``CKPT_STEPS`` steps uninterrupted, then stopped after
  ``CKPT_AT`` steps and checkpointed (rank 0 writes, the reference's
  format) and resumed from there: the same state bit for bit and the same
  losses; the consensus of its final checkpoint (``serve.consensus.
  consensus_params``) within ``LAYOUT_TOL`` of the unsharded twin's; the
  save and restore seconds;
* **(c) xlstm-350m** at full width cut to ``XLSTM_BLOCKS`` blocks (an mLSTM
  block on each rank's heads, an sLSTM block whole): a refresh and
  ``XLSTM_STEPS`` steps (the first loss, which float32 determines at this
  init, within ``LOSS_TOL`` of the twin's), then 2 requests served
  (``XLSTM_PROMPT``-token prefill, ``XLSTM_NEW`` decode steps, RMSNorm on
  each rank's rows) with the twin's tokens, and the first block's mixer
  held where float32 determines it (against its float64 run);
* **(d) jamba-1.5-large's Mamba mixer** at full width (d 8192, d_inner
  16384) on each rank's channels: a ``JAMBA_TOKENS``-token prefill,
  ``JAMBA_NEW`` decode steps and the gradient of <output, cotangent> by
  every weight and the input, within ``MIXER_RTOL`` of each one's
  largest entry;
* **(e) whisper-base** at full size served across ranks: 2 requests with
  the 1500 stub audio frames (a split encoder, cross-attention caches
  placed by ``cache_specs``), flash on each rank's decoder heads, the
  twin's tokens.
"""

from __future__ import annotations

import concurrent.futures
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
from repro_torch.models import multimodal, placed, transformer
from repro_torch.train import sharding, steps, trainer

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
# (a) the nodes over two mesh dims, against one
MULTI_SHAPE, MULTI_NAMES = (2, 2, 1), ("pod", "data", "model")
MULTI_PLAN = mesh_lib.PLANS[("multi", "faithful")]
ONE_DIM_SHAPE, ONE_DIM_NAMES = (4, 1), ("data", "model")
MULTI_M, MULTI_STEPS, MULTI_GOSSIP, MULTI_LAYERS = 4, 1, "ppermute", 1
# (b) a run stopped and checkpointed after CKPT_AT of its CKPT_STEPS steps,
# then resumed
CKPT_LAYERS, CKPT_STEPS, CKPT_AT = 1, 2, 1
# (c) xlstm-350m cut to an mLSTM and an sLSTM block
XLSTM_BLOCKS, XLSTM_STEPS, XLSTM_PROMPT, XLSTM_NEW = 2, 1, 64, 4
# (d) jamba-1.5-large's Mamba mixer; (e) whisper-base
JAMBA_TOKENS, JAMBA_NEW = 512, 4
WHISPER_PROMPT, WHISPER_NEW = 16, 4
TIMEOUT = 600.0
PARAMS_TOL, LOSS_TOL = 5e-5, 1e-5      # test_eight_device_equivalence
LAYOUT_TOL = 1e-6
LOGITS_TOL = 1e-3
KERNEL_TOL = dict(rtol=1e-5, atol=2e-5)
# the Mamba mixer: each output, state and gradient within this share of
# its largest entry (products and sums split over channels and rows)
MIXER_RTOL = 1e-5
# the mLSTM mixer: positions where the twin lies within this share of the
# float64 run's largest |y| are float32-determined, and held there
MLSTM_RTOL = 1e-4
SMOKE = False          # the smoke variants' widths: a CPU rehearsal
TWIN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "phase31")


def config(serve: bool, layers: int | None = None,
           arch: str = "h2o-danube-1.8b"):
    """``arch`` at full width (its smoke variant with ``SMOKE``), cut to
    ``layers`` (``LAYERS``; None keeps an arch's own depth but danube's);
    served through the kernels, trained on the plain path (the kernels
    have no backward)."""
    cfg = configs.get_config(arch)
    if SMOKE:
        cfg = configs.smoke_variant(cfg)
    if layers is None and arch == "h2o-danube-1.8b":
        layers = LAYERS
    if layers is not None:
        cfg = cfg.scaled(num_layers=layers)
    return cfg.scaled(use_flash=serve, use_fused_norm=serve)


def loader(m: int = M, vocab: int | None = None) -> LMLoader:
    vocab = vocab or config(False).vocab_size
    tokens = np.random.default_rng(SEED).integers(0, vocab,
                                                  size=m * 4 * SEQ)
    return LMLoader(tokens, num_nodes=m, per_node_batch=PER_NODE_BATCH,
                    seq_len=SEQ, seed=SEED)


def trainer_config(steps_: int = TRAIN_STEPS, **kw) -> trainer.TrainerConfig:
    base = dict(num_steps=steps_, snapshot_every=steps_, log_every=1,
                alpha=0.05, consensus_rounds=2, seed=SEED, gossip="dense")
    return trainer.TrainerConfig(**dict(base, **kw))


def train(device, mesh=None, steps_: int = TRAIN_STEPS, *, cfg=None,
          m: int = M, plan=PLAN, resume: bool = False, **kw) -> dict:
    """``train_loop`` of ``cfg`` (danube at ``LAYERS``) on ``m`` nodes,
    sharded by ``plan`` over ``mesh`` when given; ``kw`` overrides
    ``trainer_config``'s fields."""
    cfg = cfg or config(False)
    return trainer.train_loop(
        cfg, prox.l1(LAM), graphs.b_connected_ring_schedule(m, b=1, seed=0),
        loader(m, cfg.vocab_size), trainer_config(steps_, **kw), mesh=mesh,
        plan=None if mesh is None else plan, exec=ExecSpec(device=device),
        resume=resume)


def prompts(device, vocab: int, length: int = PROMPT) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, vocab, size=(REQUESTS, length)), device=device)


def serve(device, mesh=None, cfg=None, prompt: int = PROMPT,
          new: int = NEW) -> dict:
    """A prefill of every request (after the config's stub audio frames),
    then ``new`` greedy decode steps: the tokens and each step's logits,
    whole, and the seconds of each part."""
    cfg = cfg or config(True)
    bundle = steps.build_serve_steps(cfg, plan=None if mesh is None
                                     else PLAN, mesh=mesh)
    params = bundle.place_params(transformer.init_params(cfg, SEED, device))
    whole = lambda x: x.full_tensor() if placed.is_placed(x) else x  # noqa
    modality = {}
    if cfg.encoder_layers:
        modality["audio_frames"] = torch.as_tensor(
            multimodal.fake_audio_frames(REQUESTS, cfg.d_model,
                                         frames=cfg.encoder_seq, seed=SEED),
            device=device)
    common.sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill_step(
        params, prompts(device, cfg.vocab_size, prompt),
        max_len=prompt + new, **modality)
    outs, toks = [whole(logits)], []
    common.sync(device)
    t1 = time.perf_counter()
    for _ in range(new):
        tok = torch.argmax(outs[-1], dim=-1)
        toks.append(tok)
        logits, cache = bundle.decode_step(params, cache, tok)
        outs.append(whole(logits))
    common.sync(device)
    return {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
            "logits": torch.stack(outs).cpu().numpy(),
            "prefill_s": t1 - t0,
            "decode_ms": (time.perf_counter() - t1) / new * 1e3}


def _row_slices(x, rows: slice) -> tuple:
    """The slices of the whole stacked leaf that the rank's shard ``x``
    (its rows of the node axis, a DTensor over the rest) holds."""
    if not placed.is_placed(x):
        return (rows,)
    return (rows,) + sharding.shard_slices(x)[1:]


def _local(x):
    return (x.to_local() if placed.is_placed(x) else x).detach().cpu()


def _vs_twin(params, rows: slice, path: str) -> float:
    """Largest difference of the rank's shards from the unsharded run's
    parameters saved under ``path``."""
    _await(path)
    twin = torch.load(path, mmap=True, map_location="cpu")
    worst = 0.0
    for key, x in pytree.tree_flatten_with_path(params)[0]:
        want = twin[pytree.keystr(key)][_row_slices(x, rows)]
        worst = max(worst, float((_local(x) - want).abs().max()))
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


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _timed(fn, device):
    common.sync(device)
    t0 = time.perf_counter()
    out = fn()
    common.sync(device)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# (a) the nodes over two mesh dims
# ---------------------------------------------------------------------------

def multi_dim_nodes(device) -> dict:
    """The ("multi", "faithful") run against the one-dim run of the same
    m = MULTI_M nodes: each rank holds one node's row whole (model=1) in
    both, so its rows are compared directly."""
    runs = {}
    meshes = {}
    for name, shape, names, plan in (
            ("multi", MULTI_SHAPE, MULTI_NAMES, MULTI_PLAN),
            ("one_dim", ONE_DIM_SHAPE, ONE_DIM_NAMES, PLAN)):
        mesh = meshes[name] = mesh_lib.make_mesh(shape, names, device)
        hist, seconds = _timed(lambda: train(  # noqa: B023
            device, mesh, MULTI_STEPS, cfg=config(False, MULTI_LAYERS),
            m=MULTI_M, plan=plan, gossip=MULTI_GOSSIP), device)
        runs[name] = {"loss": np.asarray(hist["loss"]),
                      "wire_bytes": np.asarray(hist["wire_bytes"]),
                      "wire": hist["wire"], "seconds": seconds,
                      "params": pytree.tree_map(
                          _local, hist["final_state"].params)}
        del hist
        _free(device)
    a, b = runs["multi"], runs["one_dim"]
    params_diff = max(float((x - y).abs().max()) for x, y in zip(
        pytree.tree_leaves(a["params"]), pytree.tree_leaves(b["params"])))
    layout = steps.node_layout(meshes["multi"], MULTI_PLAN, MULTI_M)
    return {"node_index": layout.axis.index,
            "node_mesh": layout.node_mesh.mesh_dim_names[0],
            "max_abs_params": params_diff,
            "max_abs_loss": float(np.abs(a["loss"] - b["loss"]).max()),
            "wire_bytes_equal": bool(np.array_equal(a["wire_bytes"],
                                                    b["wire_bytes"])),
            "wire_bytes": int(a["wire_bytes"][-1]), "wire": a["wire"],
            "multi_s": a["seconds"], "one_dim_s": b["seconds"]}


# ---------------------------------------------------------------------------
# (b) checkpoints of a sharded run
# ---------------------------------------------------------------------------

def _timing(module, name: str, log: list):
    """``module.name`` wrapped to append its seconds to ``log``."""
    real = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        log.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    return real


def checkpointed(device, mesh, ckpt_dir: str) -> dict:
    """Danube cut to CKPT_LAYERS: CKPT_STEPS steps uninterrupted, then the
    same run stopped after CKPT_AT steps and checkpointed (rank 0
    writes), and resumed from that checkpoint to CKPT_STEPS (checkpointed
    there too, for the consensus): its state bit for bit the uninterrupted
    one's, its losses the same; the seconds of each save (and of rank 0's
    write within it, which overlaps the gather) and restore."""
    from repro_torch import checkpoint as ckpt_lib
    cfg = config(False, CKPT_LAYERS)
    saves, writes, restores = [], [], []
    real_save = _timing(trainer, "_save_sharded", saves)
    real_write = _timing(ckpt_lib, "save", writes)
    real_restore = _timing(trainer, "_restore_sharded", restores)
    try:
        full, full_s = _timed(lambda: train(device, mesh, CKPT_STEPS,
                                            cfg=cfg), device)
        _, stopped_s = _timed(lambda: train(device, mesh, CKPT_AT,
                                            cfg=cfg, ckpt_dir=ckpt_dir),
                              device)
        resumed, resumed_s = _timed(lambda: train(
            device, mesh, CKPT_STEPS, cfg=cfg, ckpt_dir=ckpt_dir,
            resume=True), device)
    finally:
        trainer._save_sharded = real_save
        ckpt_lib.save = real_write
        trainer._restore_sharded = real_restore
    state, got = full["final_state"], resumed["final_state"]
    bitwise = all(
        torch.equal(_local(a), _local(b)) for field in
        ("params", "snapshot", "full_grad") for a, b in zip(
            pytree.tree_leaves(getattr(state, field)),
            pytree.tree_leaves(getattr(got, field))))
    tail = len(resumed["loss"])
    return {"bitwise": bitwise,
            "losses_equal": bool(np.array_equal(
                np.asarray(full["loss"][-tail:]),
                np.asarray(resumed["loss"]))),
            "resumed_steps": list(resumed["step"]),
            "save_s": saves, "write_s": writes, "restore_s": restores,
            "full_s": full_s,
            "stopped_s": stopped_s, "resumed_s": resumed_s}


# ---------------------------------------------------------------------------
# (c) xlstm-350m, (d) jamba's Mamba mixer
# ---------------------------------------------------------------------------

def xlstm_config(serve: bool):
    return config(serve, XLSTM_BLOCKS, "xlstm-350m")


def mixer_inputs(kind: str, device, tokens: int) -> dict:
    """A ``kind`` mixer of its config at full width (jamba's Mamba, xlstm's
    first mLSTM block), its input (REQUESTS, tokens, d), one decode
    token's inputs and a cotangent of the output, from the seed."""
    from repro_torch.models import common as mcommon, ssm
    arch = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-350m"}[kind]
    cfg = config(False, None, arch)
    spec = next(getattr(p, kind) for p in transformer.layer_plan(cfg)
                if p.mixer == kind)
    init = {"mamba": ssm.init_mamba, "mlstm": ssm.init_mlstm}[kind]
    params = init(mcommon.make_generator(SEED, device), spec)
    gen = torch.Generator(device=device).manual_seed(SEED)
    shape = (REQUESTS, tokens, cfg.d_model)
    return {"spec": spec, "params": params,
            "x": torch.randn(shape, generator=gen, device=device),
            "x_t": [torch.randn((REQUESTS, 1, cfg.d_model), generator=gen,
                                device=device) for _ in range(JAMBA_NEW)],
            "cot": torch.randn(shape, generator=gen, device=device)}


def mixer_run(kind: str, inputs: dict, mesh=None, grads: bool = True
              ) -> dict:
    """The mixer on ``inputs``, on each rank's channels when ``mesh`` is
    given (the weights placed by the faithful plan's specs, the batch
    over data, the state by ``cache_specs``): the prefill's output and
    state and the decode steps' outputs and final state, and the
    gradients of <output, cot> of the first request by each weight and
    by its input (one request, whole on every data rank: a batch split
    over data would add an all-reduce of every weight's gradient, which
    the trained models' steps take)."""
    from repro_torch.models import ssm
    spec = inputs["spec"]
    fwd, pre, step = {
        "mamba": (ssm.mamba_forward, transformer._mamba_prefill,
                  ssm.mamba_step),
        "mlstm": (ssm.mlstm_forward, transformer._mlstm_prefill,
                  ssm.mlstm_step)}[kind]
    unit = spec.head_dim if kind == "mlstm" else 1
    params, x, x_t = inputs["params"], inputs["x"], inputs["x_t"]
    if mesh is not None:
        spmd.placed_wire(mesh)    # host-staged where ranks share a card
        sizes = spmd.mesh_shape(mesh)
        specs = sharding.param_specs(params, PLAN, axis_sizes=sizes)
        params = {k: sharding.place(v, mesh, sharding.placements(
            specs[k], mesh)) for k, v in params.items()}
        batch = sharding.placements(("data", None, None), mesh)
        x = sharding.place(x, mesh, batch)
        x_t = [sharding.place(t, mesh, batch) for t in x_t]

    def call(fn, *args):
        return placed.channel_call(fn, kind, params, spec, *args,
                                   unit=unit)

    out = {}
    if grads:
        x1 = inputs["x"][:1]
        if mesh is not None:
            x1 = sharding.place(x1, mesh, sharding.placements((), mesh))
        for t in list(params.values()) + [x1]:
            t.requires_grad_(True)
        y = call(fwd, x1)
        whole = y.full_tensor() if placed.is_placed(y) else y
        leaves = dict(params, x=x1)
        out["grads"] = dict(zip(leaves, torch.autograd.grad(
            (whole * inputs["cot"][:1]).sum(), list(leaves.values()))))
        del y, whole
        for t in list(params.values()) + [x1]:
            t.requires_grad_(False)
    with torch.no_grad():
        out["y"], state = call(pre, x)
        if mesh is not None:
            cspecs = sharding.cache_specs(state, PLAN, axis_sizes=sizes)
            state = {k: v.redistribute(mesh, sharding.placements(
                cspecs[k], mesh)) for k, v in state.items()}
        out["state"] = state
        out["steps"] = []
        for t in x_t:
            yt, state = call(step, t, state)
            out["steps"].append(yt)
        out["last_state"] = state
    # a partial sum (the out-projection's) summed, so that each rank's
    # shard holds whole values
    return pytree.tree_map(placed.whole_last_dim, out)


def _vs_saved(got, path: str, rtol: float) -> dict:
    """Each leaf of ``got`` (placed or whole) against the whole leaves
    saved under ``path``, by key: the largest difference over the slices
    the rank holds, relative to each whole leaf's largest entry."""
    _await(path)
    want = torch.load(path, mmap=True, map_location="cpu")
    worst = {}
    for key, x in pytree.tree_flatten_with_path(got)[0]:
        key = pytree.keystr(key)
        scale = float(want[key + "|max"])
        sl = sharding.shard_slices(x) if placed.is_placed(x) else ()
        local = x.to_local() if placed.is_placed(x) else x
        err = float((local - want[key][sl].to(local.device)).abs().max())
        worst[key] = err / max(scale, 1e-30)
        if not worst[key] <= rtol:
            raise AssertionError(f"{key}: {err:.3g} from the unsharded "
                                 f"twin, over {rtol} of its largest entry "
                                 f"{scale:.3g}")
    return {"max_rel": max(worst.values()), "leaves": len(worst)}


def _save_whole(tree, path: str) -> None:
    flat = {}
    for key, x in pytree.tree_flatten_with_path(tree)[0]:
        key = pytree.keystr(key)
        flat[key] = x.detach().cpu()
        flat[key + "|max"] = flat[key].abs().max()
    torch.save(flat, path)


def held_where_determined(got, want, want64, rtol: float) -> dict:
    """Rows (the positions of the first request) of ``got`` held within
    ``rtol`` of the float64 run's largest |y| from ``want`` (the unsharded
    float32 run) and ``want64`` where float32 determines them: row 0, and
    the rows where ``want`` lies within a quarter of that of ``want64``;
    the others recorded."""
    got, want, want64 = (torch.as_tensor(t).detach().double().cpu()[0]
                         for t in (got, want, want64))
    tol = rtol * float(want64.abs().max())
    e64 = (want - want64).abs().amax(-1)
    held = [t for t in range(got.shape[0])
            if t == 0 or e64[t] <= 0.25 * tol]
    free = [t for t in range(got.shape[0]) if t not in held]
    err = max(float((got[held] - want[held]).abs().max()),
              float((got[held] - want64[held]).abs().max()))
    if not err <= tol:
        raise AssertionError(f"mLSTM layer: {err:.3g} from the float32 "
                             f"and float64 runs where float32 determines "
                             f"the output, over {tol:.3g}")
    return {"held_rows": len(held), "rows": got.shape[0],
            "max_abs_err_held": err,
            "max_abs_err_free": float((got[free] - want[free]).abs().max())
            if free else 0.0}


def xlstm_runs(device, mesh) -> dict:
    """xlstm cut to XLSTM_BLOCKS: trained (a refresh and XLSTM_STEPS
    steps), served, and its first mLSTM mixer's output (whole), which
    this process's parent holds to its twin."""
    hist, train_s = _timed(lambda: train(
        device, mesh, XLSTM_STEPS, cfg=xlstm_config(False)), device)
    out = {"loss": np.asarray(hist["loss"]),
           "wire_bytes": np.asarray(hist["wire_bytes"]),
           "finite": all(bool(torch.isfinite(_local(x)).all()) for x in
                         pytree.tree_leaves(hist["final_state"].params)),
           "train_s": train_s}
    del hist
    _free(device)
    fa_ops.launches = rn_ops.launches = 0
    out["serve"] = serve(device, mesh, xlstm_config(True), XLSTM_PROMPT,
                         XLSTM_NEW)
    out["launches"] = {"flash_attention": fa_ops.launches,
                       "rmsnorm": rn_ops.launches}
    inputs = mixer_inputs("mlstm", device, XLSTM_PROMPT)
    y = mixer_run("mlstm", inputs, mesh, grads=False)["y"]
    out["mlstm_y"] = (y.full_tensor() if placed.is_placed(y) else y).cpu()
    return out


def mamba_layer(device, mesh, twin_path: str) -> dict:
    """jamba's Mamba mixer on each rank's channels against the twin's
    outputs, states and gradients saved under ``twin_path``."""
    inputs = mixer_inputs("mamba", device, JAMBA_TOKENS)
    got, seconds = _timed(lambda: mixer_run("mamba", inputs, mesh), device)
    return dict(_vs_saved(got, twin_path, MIXER_RTOL), seconds=seconds)


def rank_runs(device: str, twin_path: str, t_spawn: float,
              sizes: dict, before=None) -> dict:
    """Every run of the phase on this rank (``spmd.spawn`` starts the
    ranks; each makes the same calls) at the parent's ``sizes``, after
    ``before`` (a module-level function and its arguments, another
    phase's rank work, which shares this group in place of a spawn of its
    own), whose result goes under ``"before"``."""
    globals().update(sizes)
    stage = {"entered": time.time() - t_spawn}
    seconds = {}
    out = {}
    if before is not None:
        fn, args = before
        out["before"] = fn(*args)
        _free(device)
        stage["before"] = time.time() - t_spawn
    mesh = mesh_lib.make_mesh(MESH_SHAPE, MESH_NAMES, device)
    layout = steps.node_layout(mesh, PLAN, M)
    hist, train_s = _timed(lambda: train(device, mesh), device)
    stage["train"] = time.time() - t_spawn
    out.update(loss=np.asarray(hist["loss"]),
               wire_bytes=np.asarray(hist["wire_bytes"]),
               wire=hist["wire"], placed_wire=layout.wire, train_s=train_s,
               params_vs_unsharded=_vs_twin(hist["final_state"].params,
                                            layout.axis.rows, twin_path))
    del hist
    _free(device)
    fa_ops.launches = rn_ops.launches = 0
    out["serve"] = serve(device, mesh)
    out["launches"] = {"flash_attention": fa_ops.launches,
                       "rmsnorm": rn_ops.launches}
    stage["serve"] = time.time() - t_spawn
    out["kernels_vs_plain"] = _kernels_vs_plain(device)
    out["trace"] = _traced_step(device, mesh)
    stage["danube"] = time.time() - t_spawn
    t0 = time.perf_counter()
    out["multi"] = multi_dim_nodes(device)
    seconds["a_multi_dim_nodes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ckpt"] = checkpointed(device, mesh, os.path.join(TWIN_DIR,
                                                          "ckpt-sharded"))
    seconds["b_checkpoints"] = time.perf_counter() - t0
    _free(device)
    t0 = time.perf_counter()
    out["xlstm"] = xlstm_runs(device, mesh)
    seconds["c_xlstm"] = time.perf_counter() - t0
    _free(device)
    t0 = time.perf_counter()
    out["mamba"] = mamba_layer(device, mesh, os.path.join(TWIN_DIR,
                                                          "mamba.pt"))
    seconds["d_mamba_layer"] = time.perf_counter() - t0
    _free(device)
    t0 = time.perf_counter()
    fa_ops.launches = rn_ops.launches = 0
    out["whisper"] = serve(device, mesh, config(True, None, "whisper-base"),
                           WHISPER_PROMPT, WHISPER_NEW)
    out["whisper"]["launches"] = {"flash_attention": fa_ops.launches,
                                  "rmsnorm": rn_ops.launches}
    seconds["e_whisper"] = time.perf_counter() - t0
    stage["done"] = time.time() - t_spawn
    out["stage_s"] = stage
    out["seconds"] = seconds
    if device == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _publish(save, path: str) -> None:
    """``save(tmp)`` then renamed to ``path``: a rank waiting for ``path``
    never reads it half written."""
    save(path + ".part")
    os.replace(path + ".part", path)


def _await(path: str) -> None:
    """Wait for this process's parent to publish ``path`` (it computes the
    unsharded twins while the ranks work); fail where it failed."""
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if os.path.exists(os.path.join(TWIN_DIR, "failed")):
            raise RuntimeError("the unsharded twins failed in the parent")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not published in {TIMEOUT:.0f} s")
        time.sleep(0.2)


def _twins(kind: str, twin_path: str) -> dict:
    """The unsharded runs, computed while the ranks work: first what the
    ranks read from disk (danube's trained parameters, the Mamba mixer's
    outputs, states and gradients), then the checkpointed twin (its
    consensus) and what this process holds the ranks' results to
    (danube's, whisper's and xlstm's serving, xlstm's training and its
    first mLSTM mixer, with its float64 run)."""
    from repro_torch.models import ssm
    device = torch.device(kind)
    out = {}
    twin, out["unsharded_train_s"] = _timed(lambda: train(kind), device)
    _publish(lambda path: torch.save(
        {pytree.keystr(k): v.cpu() for k, v in pytree.tree_flatten_with_path(
            twin["final_state"].params)[0]}, path), twin_path)
    out["twin"] = {k: twin[k] for k in ("loss", "wire_bytes")}
    del twin
    _free(kind)
    inputs = mixer_inputs("mamba", kind, JAMBA_TOKENS)
    mamba, out["unsharded_mamba_s"] = _timed(
        lambda: mixer_run("mamba", inputs), device)
    _publish(lambda path: _save_whole(mamba, path),
             os.path.join(TWIN_DIR, "mamba.pt"))
    del mamba, inputs
    _free(kind)
    train(kind, None, CKPT_STEPS, cfg=config(False, CKPT_LAYERS),
          ckpt_dir=os.path.join(TWIN_DIR, "ckpt-unsharded"))
    out["consensus"] = _consensus("ckpt-unsharded", device)
    _free(kind)
    out["served"] = serve(kind)
    out["whisper"] = serve(kind, None, config(True, None, "whisper-base"),
                           WHISPER_PROMPT, WHISPER_NEW)
    xl = train(kind, None, XLSTM_STEPS, cfg=xlstm_config(False))
    out["xlstm_loss"] = np.asarray(xl["loss"])
    out["xlstm_wire_bytes"] = np.asarray(xl["wire_bytes"])
    del xl
    out["xlstm_serve"] = serve(kind, None, xlstm_config(True),
                               XLSTM_PROMPT, XLSTM_NEW)
    inputs = mixer_inputs("mlstm", kind, XLSTM_PROMPT)
    out["mlstm_y"] = mixer_run("mlstm", inputs, grads=False)["y"].cpu()
    with common.float64_models():
        out["mlstm_y64"] = ssm.mlstm_forward(
            {k: v.double() for k, v in inputs["params"].items()},
            inputs["spec"], inputs["x"].double()).cpu()
    del inputs
    _free(kind)
    return out


def _consensus(name: str, device):
    """The consensus (``serve.consensus.consensus_params``) of the latest
    checkpoint under ``TWIN_DIR/name``."""
    from repro_torch.serve import consensus
    return consensus.consensus_params(os.path.join(TWIN_DIR, name),
                                      config(True, CKPT_LAYERS),
                                      device=device)[0]


def _check(ranks: list, after: dict, wire: str) -> None:
    """Raise unless every rank's runs meet their twins'."""
    twin, served = after["twin"], after["served"]
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
        multi = got["multi"]
        if not (multi["max_abs_params"] <= LAYOUT_TOL and
                multi["max_abs_loss"] <= LOSS_TOL and
                multi["wire_bytes_equal"] and multi["wire"] == wire and
                multi["node_index"] == rank):
            raise AssertionError(f"rank {rank}: nodes over two dims "
                                 f"against one: {multi}")
        ckpt = got["ckpt"]
        if not (ckpt["bitwise"] and ckpt["losses_equal"] and
                ckpt["resumed_steps"] == list(range(
                    CKPT_STEPS - CKPT_AT, CKPT_STEPS))):
            raise AssertionError(f"rank {rank}: the resume is not the "
                                 f"uninterrupted run: {ckpt}")
        xl = got["xlstm"]
        if not xl["finite"]:
            raise AssertionError(f"rank {rank}: xlstm's params not finite")
        np.testing.assert_allclose(xl["loss"][0], after["xlstm_loss"][0],
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_array_equal(xl["wire_bytes"],
                                      after["xlstm_wire_bytes"])
        np.testing.assert_array_equal(xl["serve"]["tokens"],
                                      after["xlstm_serve"]["tokens"])
        np.testing.assert_array_equal(got["whisper"]["tokens"],
                                      after["whisper"]["tokens"])
        np.testing.assert_allclose(got["whisper"]["logits"],
                                   after["whisper"]["logits"], rtol=0,
                                   atol=LOGITS_TOL)
    if not after["consensus_max_abs"] <= LAYOUT_TOL:
        raise AssertionError(f"the sharded checkpoint's consensus differs "
                             f"from the unsharded twin's by "
                             f"{after['consensus_max_abs']}")


def run(device="cuda", before=None, **sizes) -> dict:
    """Run the unsharded twins, spawn the ranks, hold one to the other;
    returns the phase's summary (raises on a mismatch), with each rank's
    result of ``before`` (another phase's rank work, run first in the same
    group: ``rank_runs``) under ``"before"`` where it is given.
    ``sizes`` overrides this module's sizes (``SMOKE``, ``LAYERS``,
    ``PROMPT``, ``NEW``, ``SEQ``, ``XLSTM_PROMPT``, ``JAMBA_TOKENS``, ...)
    here and on the ranks: a CPU rehearsal."""
    globals().update(sizes)
    device = common.require_device(device)
    kind = device.type
    shutil.rmtree(TWIN_DIR, ignore_errors=True)
    os.makedirs(TWIN_DIR)
    twin_path = os.path.join(TWIN_DIR, "params.pt")
    backend = spmd.backend_for(device, RANKS)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            t0 = time.perf_counter()
            spawned = pool.submit(
                spmd.spawn, rank_runs, RANKS, backend=backend, device=kind,
                args=(kind, twin_path, time.time(), sizes, before),
                timeout=TIMEOUT)
            try:
                after, twins_s = _timed(lambda: _twins(kind, twin_path),
                                        device)
                # the sharded run's last checkpoint, once rank 0 has
                # written it, while the ranks go on
                last = os.path.join(TWIN_DIR, "ckpt-sharded",
                                    f"step_{CKPT_STEPS:08d}")
                while not (os.path.exists(last) or spawned.done()):
                    time.sleep(0.2)
                sharded = _consensus("ckpt-sharded", device)
            except BaseException:
                open(os.path.join(TWIN_DIR, "failed"), "w").close()
                spawned.result()      # the ranks' failure, if theirs came
                raise
            ranks = spawned.result()
            spawn_s = time.perf_counter() - t0
        after["mlstm"] = held_where_determined(
            ranks[0]["xlstm"]["mlstm_y"], after["mlstm_y"],
            after["mlstm_y64"], MLSTM_RTOL)
        after["consensus_max_abs"] = max(
            float((a - b).abs().max()) for a, b in zip(
                pytree.tree_leaves(sharded),
                pytree.tree_leaves(after.pop("consensus"))))
    finally:
        shutil.rmtree(TWIN_DIR, ignore_errors=True)
    wire = "nccl" if backend == "nccl" else (
        "gloo-host-staged" if kind == "cuda" else "gloo")
    _check(ranks, after, wire)
    r0, served, twin = ranks[0], after["served"], after["twin"]
    extra = {} if before is None else {"before": [r.pop("before")
                                                  for r in ranks]}
    return extra | {
        "ranks": RANKS, "backend": backend, "wire": wire,
        "mesh": dict(zip(MESH_NAMES, MESH_SHAPE)), "m": M,
        "layers": LAYERS, "spawn_s": spawn_s, "rank0_stage_s": r0["stage_s"],
        "additions_s": r0["seconds"], "twins_s": twins_s,
        "train_steps": TRAIN_STEPS,
        "sharded_train_s": [r["train_s"] for r in ranks],
        "unsharded_train_s": after["unsharded_train_s"],
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
        "multi_dim_nodes": {k: v for k, v in r0["multi"].items()},
        "checkpoints": dict(r0["ckpt"], layers=CKPT_LAYERS,
                            consensus_max_abs=after["consensus_max_abs"]),
        "xlstm": {"blocks": XLSTM_BLOCKS, "train_s": r0["xlstm"]["train_s"],
                  "loss": r0["xlstm"]["loss"].tolist(),
                  "unsharded_loss": after["xlstm_loss"].tolist(),
                  "tokens_equal": True,
                  "max_abs_logits_vs_unsharded": max(
                      float(np.abs(r["xlstm"]["serve"]["logits"]
                                   - after["xlstm_serve"]["logits"]).max())
                      for r in ranks),
                  "prefill_s": r0["xlstm"]["serve"]["prefill_s"],
                  "decode_ms": r0["xlstm"]["serve"]["decode_ms"],
                  "launches_per_rank": [r["xlstm"]["launches"]
                                        for r in ranks],
                  "mlstm_layer": after["mlstm"]},
        "mamba_layer": dict(r0["mamba"], tokens=JAMBA_TOKENS,
                            decode_steps=JAMBA_NEW,
                            unsharded_s=after["unsharded_mamba_s"]),
        "whisper": {"tokens_equal": True,
                    "max_abs_logits_vs_unsharded": max(
                        float(np.abs(r["whisper"]["logits"]
                                     - after["whisper"]["logits"]).max())
                        for r in ranks),
                    "prefill_s": r0["whisper"]["prefill_s"],
                    "decode_ms": r0["whisper"]["decode_ms"],
                    "launches_per_rank": [r["whisper"]["launches"]
                                          for r in ranks]},
    }
