"""Continuous-batching serving demo with the PyTorch port: requests of
different lengths stream through a fixed pool of cache slots; finished
sequences retire and new ones are admitted mid-flight (per-slot position
vectors make this exact).  The port of examples/continuous_batching.py,
with its settings and print format.

The model is the smoke variant of ``--arch`` with random weights from seed
0, served with the RMSNorm and flash attention kernels on: on the CUDA
device (the default) they launch; on the CPU their plain versions run.

    PYTHONPATH=src python examples/torch_continuous_batching.py --arch gemma2-9b
    PYTHONPATH=src python examples/torch_continuous_batching.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve.scheduler import ContinuousBatcher, Request


def main(argv=None, params=None) -> dict:
    """Runs the demo; returns {uid: tokens}.  ``params``, when given, are
    served in place of the seed-0 init (they must lie on ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    choices=configs.ARCHITECTURES)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke_variant(configs.get_config(args.arch)).scaled(
        use_flash=True, use_fused_norm=True)
    if cfg.frontend != "none":
        raise SystemExit("use a text arch for this demo")
    if params is None:
        params = transformer.init_params(cfg, 0, args.device)
    rng = np.random.default_rng(0)

    sched = ContinuousBatcher(cfg, params, max_slots=args.slots, max_len=96)
    total_new = 0
    for uid in range(args.requests):
        plen = int(rng.integers(4, 20))
        n_new = int(rng.integers(3, 10))
        total_new += n_new
        sched.submit(Request(
            uid=uid,
            tokens=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=n_new))
        print(f"submitted uid={uid} prompt_len={plen} max_new={n_new}")

    t0 = time.time()
    outs = sched.run_until_done()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for uid in sorted(outs):
        print(f"uid={uid}: {outs[uid].tolist()}")
    print(f"\n{args.requests} requests ({total_new} tokens) through "
          f"{args.slots} slots in {dt:.1f}s — slot reuse, no head-of-line "
          f"blocking.")
    return outs


if __name__ == "__main__":
    main()
