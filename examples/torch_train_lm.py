"""End-to-end example of the port: decentralized DPSVRG training of a
decoder LM on synthetic token streams, with PyTorch.

    PYTHONPATH=src python examples/torch_train_lm.py \
        --steps 300 --nodes 4 --d-model 512 --layers 12

The port's counterpart of ``examples/train_lm.py``, with its flags plus
``--device`` (``cuda`` by default; ``--device cpu`` runs on the CPU).  The
default config is ~100M params (12L x 512d x 32k vocab); for a quick demo
on the CPU pass ``--device cpu --steps 20 --nodes 4 --layers 2 --d-model
64 --vocab 512 --seq 32 --batch 2``.  Execution defaults to the resident
path (one staging transfer, windows gathered on the device, one metrics
pull per log window); ``--host`` runs the per-step loop, and the two give
the same history.  ``--resume`` continues bitwise from the newest
checkpoint in ``--ckpt-dir``, and ``--tracker jsonl:<path>`` streams
metrics as JSON lines.
"""

import argparse
import time

from repro_torch.core import graphs, prox
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import loader, synthetic
from repro_torch.models import transformer
from repro_torch.models.api import ModelConfig
from repro_torch.train import trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4, help="per-node batch")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--lam", type=float, default=1e-6)
    ap.add_argument("--algorithm", default="dpsvrg",
                    choices=["dpsvrg", "dspg"])
    ap.add_argument("--gossip", default="auto",
                    choices=["auto", "dense", "banded", "compressed"],
                    help="transport backend (transport.GOSSIP_BACKENDS); "
                         "auto picks banded on band-structured schedules")
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--resident", dest="resident", action="store_true",
                      default=True, help="resident execution (default)")
    path.add_argument("--host", dest="resident", action="store_false",
                      help="per-step host loop (reference semantics)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=0,
                    help="prune all but N newest checkpoints (0 = keep all)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--tracker", default="",
                    help="extra metrics sink, e.g. jsonl:/tmp/metrics.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    args = ap.parse_args()

    cfg = ModelConfig(
        name=f"lm-{args.layers}x{args.d_model}", arch_type="dense",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 1),
        num_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 4, vocab_size=args.vocab)
    stream = synthetic.make_token_stream(2_000_000, cfg.vocab_size, seed=0)
    ld = loader.LMLoader(stream.tokens, num_nodes=args.nodes,
                         per_node_batch=args.batch, seq_len=args.seq)
    sched = graphs.b_connected_ring_schedule(args.nodes, b=2, seed=0)
    tc = trainer.TrainerConfig(
        num_steps=args.steps, snapshot_every=max(args.steps // 6, 25),
        alpha=args.alpha, consensus_rounds=2, algorithm=args.algorithm,
        gossip=args.gossip, log_every=10, ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every or (100 if args.ckpt_dir else 0),
        keep_last=args.keep_last or None, tracker=args.tracker or None)
    spec = ExecSpec(resident=args.resident, device=args.device)
    t0 = time.time()
    hist = trainer.train_loop(cfg, prox.l1(args.lam), sched, ld, tc,
                              exec=spec, resume=args.resume)
    dt = time.time() - t0
    n = transformer.param_count(hist["final_state"].params) // args.nodes
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params, {args.nodes} nodes, "
          f"{'resident' if args.resident else 'host'} path on "
          f"{spec.device}")
    print("\nstep  loss    v_norm      wire_MB   alpha")
    for s, l, v, w, a in zip(hist["step"], hist["loss"], hist["v_norm"],
                             hist["wire_bytes"], hist["alpha"]):
        print(f"{s:5d} {l:7.4f} {v:9.2f} {w / 1e6:10.1f} {a:9.5f}")
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.0f} ms/step); "
          f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"transfers {hist['transfers']}")


if __name__ == "__main__":
    main()
