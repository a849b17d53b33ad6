"""How far float32 determines xlstm-350m's logits: per position of one
prompt, the largest difference between the kernel path (RMSNorm kernel on
the block norms), the plain path, the same model on the CPU and the model
evaluated in float64 (``pt_common.float64_models``).

    PYTHONPATH=src python -m benchmarks.pt_xlstm_conditioning [--device cpu]
        [--smoke] [--tokens 128] [--seed 0]

At random init xlstm's mLSTM normalizer max(|n.q|, exp(-m)) has poles
where n.q crosses 0, so two float32 evaluations that sum in other orders
part where the float64 evaluation is near one; ``chip_smoke.py`` holds
xlstm's logits only where float32 determines them.  Prints one
``xlstm_conditioning`` JSON line (and the card's name and power limit on
the card).  Without a card it raises unless asked for the CPU, where the
kernel path is the kernel's plain version and no CPU twin is run.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.utils import _pytree as pytree

from benchmarks import pt_common
from repro_torch import configs
from repro_torch.models import transformer

THRESHOLD = 1e-3       # chip_smoke.py's LOGIT_TOL atol


def _per_position(a, b) -> list:
    return (a.double().cpu() - b.double().cpu()).abs().amax(-1)[0].tolist()


def _first_over(errs: list) -> int | None:
    return next((i for i, e in enumerate(errs) if e > THRESHOLD), None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke variant (2 blocks, d_model 128)")
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = pt_common.require_device(args.device)
    cfg = configs.get_config("xlstm-350m")
    if args.smoke:
        cfg = configs.smoke_variant(cfg)
    params = transformer.init_params(cfg, args.seed, device=device)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=args.tokens), device=device)[None]
    with torch.no_grad():
        kernel = transformer.forward(cfg.scaled(use_fused_norm=True),
                                     params, toks)[0]
        plain = transformer.forward(cfg, params, toks)[0]
        with pt_common.float64_models():
            exact = transformer.forward(
                cfg.scaled(param_dtype="float64", logit_dtype="float64"),
                pytree.tree_map(lambda t: t.double(), params), toks)[0]
        cpu = None
        if device.type == "cuda":
            cpu = transformer.forward(
                cfg, pytree.tree_map(lambda t: t.cpu(), params), toks.cpu())[0]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "tokens": args.tokens,
           "device": str(device), "max_abs_logit": float(exact.abs().max()),
           "per_position": {
               "kernel_vs_plain": _per_position(kernel, plain),
               "plain_vs_float64": _per_position(plain, exact),
               "kernel_vs_float64": _per_position(kernel, exact)}}
    if cpu is not None:
        out["per_position"]["cpu_vs_float64"] = _per_position(cpu, exact)
    out["first_position_over_1e-3"] = {
        k: _first_over(v) for k, v in out["per_position"].items()}
    out["max"] = {k: max(v) for k, v in out["per_position"].items()}
    out["argmax_equal_plain_float64"] = float(
        (plain.argmax(-1).cpu() == exact.argmax(-1).cpu()).double().mean())
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(out["card"], flush=True)
    print("xlstm_conditioning " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
