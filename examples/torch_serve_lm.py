"""Batched serving demo of the port: prefill a batch of prompts, decode
greedily.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-9b --new 16

The port's counterpart of ``examples/serve_lm.py``, with its flags plus
``--device`` (``cuda`` by default; ``--device cpu`` runs on the CPU).  It
uses the smoke-reduced variant of any of the ten architectures, with
random weights from seed 0; whisper-base gets stub audio frames and
llava-next-mistral-7b a stub image prefix (``models.multimodal``), drawn
as the reference example draws them.  ``generate`` is the loop, over any
parameters.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import multimodal
from repro_torch.train import steps as steps_lib


def make_inputs(cfg, batch: int, prompt_len: int):
    """(tokens, modality) as numpy: the prompts from
    ``np.random.default_rng(0)`` and the config's stub input, seed 0."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)
    kw = {}
    if cfg.frontend == "vision_stub":
        kw["image_embeds"] = multimodal.fake_image_patches(
            batch, cfg.d_model, cfg.image_tokens)
    if cfg.frontend == "audio_stub":
        kw["audio_frames"] = multimodal.fake_audio_frames(
            batch, cfg.d_model, cfg.encoder_seq)
    return toks, kw


@torch.no_grad()
def generate(cfg, params, toks, kw, new: int):
    """Greedy decode of ``new`` tokens a prompt: (tokens (B, new) numpy,
    prefill s, decode s).  ``toks`` and ``kw`` are numpy; they go to the
    params' device."""
    device = params["embed"].device
    bundle = steps_lib.build_serve_steps(cfg)
    toks_t = torch.as_tensor(toks, device=device)
    kw_t = {k: torch.as_tensor(v, device=device) for k, v in kw.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.time()
    logits, cache = bundle.prefill_step(
        params, toks_t, max_len=toks.shape[1] + new + 64, **kw_t)
    sync()
    t_prefill = time.time() - t0
    cur = torch.argmax(logits, -1).to(torch.int32)
    outs = [cur]
    t0 = time.time()
    for _ in range(new - 1):
        logits, cache = bundle.decode_step(params, cache, cur)
        cur = torch.argmax(logits, -1).to(torch.int32)
        outs.append(cur)
    sync()
    t_decode = time.time() - t0
    gen = torch.stack(outs, 1).cpu().numpy()
    return gen, t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b",
                    choices=configs.ARCHITECTURES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke_variant(configs.get_config(args.arch))
    params = steps_lib.build_serve_steps(cfg).init_params(0, args.device)
    toks, kw = make_inputs(cfg, args.batch, args.prompt_len)
    gen, t_prefill, t_decode = generate(cfg, params, toks, kw, args.new)
    print(f"arch={args.arch} (smoke variant), batch={args.batch}, "
          f"device={args.device}")
    print(f"prefill {args.prompt_len} toks: {t_prefill*1e3:.1f} ms")
    print(f"decode  {args.new} toks: {t_decode*1e3:.1f} ms "
          f"({t_decode/max(args.new-1,1)*1e3:.1f} ms/tok, "
          f"{args.batch*(args.new-1)/max(t_decode,1e-9):.0f} tok/s)")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {gen[i].tolist()}")
    return gen


if __name__ == "__main__":
    main()
