"""Training entry point of the port: the port of ``repro.launch.train``.

Config-driven front end for ``trainer.train_loop`` at the smoke variant of
``--arch``, with the reference's flags plus ``--device``:

  * execution path: ``--resident`` (plan on the host, stage once, gather
    windows on the device; the default) or ``--host`` (one batch copied
    per step); ``--sampling device`` draws the resident path's window
    starts on the device (``core.device_sampling``) instead of from the
    loader's stream,
  * persistence: ``--ckpt-dir``/``--ckpt-every``/``--keep-last``, and
    ``--resume`` to continue bitwise from ``checkpoint.latest_step``; the
    checkpoints are the JAX package's format (``repro_torch.launch.serve
    --ckpt-dir`` serves their consensus, and so does the reference's),
  * metrics: ``--tracker jsonl:<path>`` streams one JSON line per log
    window next to the in-memory history,
  * ``--device``: ``cuda`` (the default) or ``cpu``.

The reference's module docstring names a ``--mesh single|multi`` flag,
but its parser has no such flag, and neither has this one: sharded
training is ``trainer.train_loop(mesh=, plan=)``, called on every rank
(``core.spmd``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 50 --ckpt-dir /tmp/run0 --ckpt-every 25 \
        --tracker jsonl:/tmp/run0/metrics.jsonl [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--lam", type=float, default=1e-6)
    ap.add_argument("--algorithm", default="dpsvrg",
                    choices=["dpsvrg", "dspg"])
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--resident", dest="resident", action="store_true",
                      default=True,
                      help="plan on the host, stage once, gather windows on "
                           "the device (default)")
    path.add_argument("--host", dest="resident", action="store_false",
                      help="per-step host loop")
    ap.add_argument("--sampling", default="host", choices=["host", "device"],
                    help="where the resident path draws minibatch window "
                         "starts: host (the loader's np.random stream) or "
                         "device (a counter-based stream on the device; "
                         "needs --resident)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=0,
                    help="prune all but the N newest checkpoints (0 = keep "
                         "everything)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from checkpoint.latest_step(ckpt_dir)")
    ap.add_argument("--tracker", default="",
                    help="extra metrics sink, e.g. jsonl:/tmp/metrics.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.core import graphs, prox
    from repro_torch.core.exec_spec import ExecSpec
    from repro_torch.data import loader, synthetic
    from repro_torch.train import trainer

    cfg = configs.smoke_variant(configs.get_config(args.arch))
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch}: train drives the token path; pick "
                         "a text arch")
    stream = synthetic.make_token_stream(500_000, cfg.vocab_size, seed=0)
    ld = loader.LMLoader(stream.tokens, num_nodes=args.nodes,
                         per_node_batch=4, seq_len=64)

    sched = graphs.b_connected_ring_schedule(args.nodes, b=2, seed=0)
    tc = trainer.TrainerConfig(
        num_steps=args.steps, snapshot_every=max(args.steps // 4, 10),
        alpha=args.alpha, consensus_rounds=2, algorithm=args.algorithm,
        log_every=max(args.steps // 10, 1),
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every or (args.steps if args.ckpt_dir else 0),
        keep_last=args.keep_last or None,
        resident=args.resident, sampling=args.sampling,
        tracker=args.tracker or None)
    hist = trainer.train_loop(
        cfg, prox.l1(args.lam), sched, ld, tc,
        exec=ExecSpec(resident=args.resident, sampling=args.sampling,
                      device=args.device),
        resume=args.resume)
    print("step loss:", list(zip(hist["step"],
                                 [round(l, 4) for l in hist["loss"]])))
    print("transfers:", hist["transfers"])
    return hist


if __name__ == "__main__":
    main()
