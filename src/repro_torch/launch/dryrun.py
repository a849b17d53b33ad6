"""Dry run of every (architecture x input shape) on one H100: the step's
FLOPs counted on the meta device, its arguments' bytes, and the roofline
terms at the card's published rates.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
step for a TPU pod.  Here each step is built through the port's own
builders (``train/steps.py`` ``build_train_step`` and
``build_serve_steps``) on the plain path, with every parameter, state,
batch and cache a ``meta`` tensor: shapes and dtypes, nothing allocated,
nothing computed.  The step runs under
``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of
``cost_analysis()["flops"]``), in bf16 as the reference's ``PARAM_DTYPE``.

  * ``counted_gflops`` is what the counter saw: the products of the plain
    path.  The CUDA kernels are reached through ``ctypes`` and are not
    used here (neither meta tensors nor the counter could see them).
  * On meta tensors an operation still costs tens of microseconds of
    Python, and the SSM time loops (``models/ssm.py``) run one iteration
    a token: 32k or 524k tokens times 24-72 layers would take hours.  So
    the step is counted on cut models and extrapolated linearly, which is
    exact: one and two periods of the layer plan (every period does the
    same work), and the SSM loops at one and two time steps (the loop
    body's work does not depend on t).  The row's ``note`` says so.
  * ``bytes_per_device`` sums the arguments' shapes; ``fits`` compares it
    with the card's 80 GB.
  * The compute and memory terms come from ``launch/analytic.py``, as in
    the reference; the collective term from the step's collectives, none
    on one card.

One card runs one node of the decentralized trainer (m = 1: the
reference's faithful mapping, one node a data-parallel rank).  The
reference's pod meshes (``--mesh single|multi``, ``--mapping``,
``--gossip banded``, ``--serve-attn-dim0``, ``--pin-serve-outputs``,
``--moe-groups``, ``--constrain-attn``) are multi-device work and raise.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--algorithm dpsvrg|dspg] [--out rows.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..core import prox as prox_lib
from . import analytic, roofline
from ..models import ssm, transformer
from ..models.api import layer_plan
from ..train import steps as steps_lib

PARAM_DTYPE = "bfloat16"     # the reference's dry-run precision
MESH = "h100x1"              # one card
NODES = 1                    # one node of the trainer a card
CARD_BYTES = 80e9            # the H100's device memory
_MESH_ITEM = "ROADMAP Queue 1 item 14"

__all__ = ["run_one", "run_config", "count_step", "main", "PARAM_DTYPE",
           "MESH"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype)
                       if isinstance(dtype, str) else dtype, device="meta")


def _modalities(cfg, lead: tuple) -> dict:
    """The stub image or audio inputs a frontend needs, ``lead`` + (P, d)."""
    out = {}
    if cfg.frontend == "vision_stub":
        out["image_embeds"] = _meta(lead + (cfg.image_tokens, cfg.d_model),
                                    PARAM_DTYPE)
    if cfg.frontend == "audio_stub":
        out["audio_frames"] = _meta(lead + (cfg.encoder_seq, cfg.d_model),
                                    PARAM_DTYPE)
    return out


def _arg_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in pytree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


def _step(cfg, shape, m: int, algorithm: str):
    """(run, args): ``run()`` performs one step of ``shape.kind`` on meta
    tensors through the port's step builders; ``args`` its arguments."""
    if shape.kind == "train":
        bundle = steps_lib.build_train_step(cfg, prox_lib.l1(1e-5), m,
                                            algorithm=algorithm)
        state = bundle.init_state(0, "meta")
        per_node = max(shape.global_batch // m, 1)
        batch = {"tokens": _meta((m, per_node, shape.seq_len), "int32"),
                 "labels": _meta((m, per_node, shape.seq_len), "int32"),
                 **_modalities(cfg, (m, per_node))}
        phi = _meta((m, m), "float32")
        return (lambda: bundle.train_step(state, batch, phi, 0.1),
                (state, batch))
    serve = steps_lib.build_serve_steps(cfg)
    params = serve.init_params(0, "meta")
    b = shape.global_batch
    if shape.kind == "prefill":
        toks = _meta((b, shape.seq_len), "int32")
        kw = _modalities(cfg, (b,))
        return (lambda: serve.prefill_step(params, toks,
                                           max_len=shape.seq_len, **kw),
                (params, toks, kw))
    cache = transformer.init_cache(cfg, b, shape.seq_len,
                                   getattr(torch, PARAM_DTYPE), "meta")
    tok = _meta((b,), "int32")
    return (lambda: serve.decode_step(params, cache, tok),
            (params, cache, tok))


def _cut_time(fn, steps: int, timed: tuple):
    """``fn`` with its time loop cut to ``steps``: the arguments at the
    positions ``timed`` are sliced to their first ``steps`` time steps
    (dim 1) and the per-step outputs (the second result) padded back to the
    full length with zeros."""
    def cut(*args):
        length = args[timed[0]].shape[1]
        if length <= steps:
            return fn(*args)
        args = [a[:, :steps] if i in timed else a for i, a in enumerate(args)]
        state, ys = fn(*args)
        pad = ys.new_zeros((ys.shape[0], length - steps) + ys.shape[2:])
        return state, torch.cat([ys, pad], dim=1)
    return cut


@contextlib.contextmanager
def _ssm_loops_cut(steps: int):
    saved = (ssm._mamba_scan_chunk, ssm._mlstm_scan, ssm._slstm_scan)
    ssm._mamba_scan_chunk = _cut_time(saved[0], steps, (1, 2, 3, 4))
    ssm._mlstm_scan = _cut_time(saved[1], steps, (1, 2, 3, 4, 5))
    ssm._slstm_scan = _cut_time(saved[2], steps, (2,))
    try:
        yield
    finally:
        ssm._mamba_scan_chunk, ssm._mlstm_scan, ssm._slstm_scan = saved


def _count(run) -> int:
    with FlopCounterMode(display=False) as counter:
        run()
    return counter.get_total_flops()


def _period(cfg) -> int:
    """The shortest run of layers whose plan repeats through the stack (the
    whole depth if none does)."""
    plans = layer_plan(cfg)
    n = len(plans)
    for p in range(1, n // 2 + 1):
        if n % p == 0 and all(plans[i] == plans[i % p] for i in range(n)):
            return p
    return n


def count_step(cfg, shape, m: int = NODES, algorithm: str = "dpsvrg"
               ) -> tuple:
    """(counted FLOPs, argument bytes, note) of one step on meta tensors.

    On meta tensors every operation still costs tens of microseconds of
    Python, so the step is counted on cut models and extrapolated
    linearly, exactly: the stack at one and two periods of its layer plan
    (``_period``: every period does the same work), and the SSM time
    loops at one and two steps.  With n periods and S steps the count is
    c(1, 1) + (n - 1) * [c(2, 1) - c(1, 1)] + (S - 1) * n * [c(1, 2) -
    c(1, 1)]."""
    args = _step(cfg, shape, m, algorithm)[1]
    period = _period(cfg)
    n = cfg.num_layers // period
    steps = shape.seq_len if shape.kind != "decode" and any(
        mixer != "attn" for mixer in cfg.mixer_pattern) else 1

    def count(periods: int, loop_steps: int) -> int:
        run = _step(cfg.scaled(num_layers=periods * period), shape, m,
                    algorithm)[0]
        cut = _ssm_loops_cut(loop_steps) if steps > 1 \
            else contextlib.nullcontext()
        with cut:
            return _count(run)

    c11 = count(1, 1)
    counted = c11
    notes = []
    if n > 1:
        counted += (n - 1) * (count(2, 1) - c11)
        notes.append(f"layers counted at {period} and {2 * period} of "
                     f"{cfg.num_layers}")
    if steps > 1:
        counted += (steps - 1) * n * (count(1, 2) - c11)
        notes.append(f"SSM loops at 1 and 2 of {steps} steps")
    note = "; ".join(notes) + (", extrapolated linearly" if notes else "")
    return counted, _arg_bytes(args), note


def run_one(arch: str, shape_name: str, hw: roofline.HW,
            algorithm: str = "dpsvrg") -> dict:
    cfg = configs.get_config(arch).scaled(param_dtype=PARAM_DTYPE)
    return run_config(cfg, configs.INPUT_SHAPES[shape_name], hw, algorithm,
                      arch=arch)


def run_config(cfg, shape, hw: roofline.HW, algorithm: str = "dpsvrg",
               arch: str | None = None) -> dict:
    """The dry-run row of ``cfg`` at ``shape`` (an ``InputShape``)."""
    arch, shape_name = arch or cfg.name, shape.name
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": MESH,
                "status": "skipped", "reason": reason}
    hw = dataclasses.replace(hw, chips=1)
    t0 = time.time()
    counted, arg_bytes, note = count_step(cfg, shape, NODES, algorithm)
    n_active = analytic.active_param_count(cfg)
    mfl = roofline.model_flops(cfg, shape, n_active)
    m_for_bytes = NODES if shape.kind == "train" else 1
    afl = analytic.step_flops(cfg, shape, algorithm)
    aby = analytic.step_bytes(cfg, shape, m_for_bytes, algorithm=algorithm)
    report = roofline.roofline_terms(
        arch, shape_name, MESH, counted, arg_bytes, None, hw, mfl, afl, aby,
        dtype=PARAM_DTYPE, note=note, bytes_per_device=arg_bytes / hw.chips)
    row = report.as_row()
    row.update({
        "status": "ok",
        "kind": shape.kind,
        "chips": hw.chips,
        "nodes": NODES if shape.kind == "train" else None,
        "algorithm": algorithm if shape.kind == "train" else "serve",
        "active_params": n_active,
        "fits": arg_bytes / hw.chips <= CARD_BYTES,
        "build_s": round(time.time() - t0, 2),
    })
    print(roofline.format_report(report), flush=True)
    return row


def _refuse_meshes(args) -> None:
    """The reference's pod-mesh flags: multi-device work, not ported."""
    asked = [flag for flag, on in (
        (f"--mesh {args.mesh}", args.mesh != MESH),
        (f"--mapping {args.mapping}", args.mapping != "auto"),
        ("--gossip banded", args.gossip == "banded"),
        ("--serve-attn-dim0", args.serve_attn_dim0),
        ("--pin-serve-outputs", args.pin_serve_outputs),
        (f"--moe-groups {args.moe_groups}", args.moe_groups != 1),
        ("--constrain-attn", args.constrain_attn)) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the pod meshes and their sharding are "
            f"multi-device work, not ported to PyTorch yet ({_MESH_ITEM}); "
            f"the port's dry run covers one card (--mesh {MESH})")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--mapping", default="auto")
    ap.add_argument("--algorithm", default="dpsvrg",
                    choices=["dpsvrg", "dspg"])
    ap.add_argument("--gossip", default="dense", choices=["dense", "banded"])
    ap.add_argument("--pin-serve-outputs", action="store_true")
    ap.add_argument("--serve-attn-dim0", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--constrain-attn", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _refuse_meshes(args)

    archs = configs.ARCHITECTURES if args.arch == "all" else [args.arch]
    shapes = list(configs.INPUT_SHAPES) if args.shape == "all" \
        else [args.shape]
    rows = []
    for arch in archs:
        for shape in shapes:
            try:
                row = run_one(arch, shape, roofline.HW(),
                              algorithm=args.algorithm)
            except Exception as e:
                traceback.print_exc()
                row = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
            rows.append(row)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1, default=str)
    n_ok = sum(r.get("status") == "ok" for r in rows)
    n_skip = sum(r.get("status") == "skipped" for r in rows)
    n_err = sum(r.get("status") == "error" for r in rows)
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors over {len(rows)} combos")
    if n_err:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
