"""Serving entry point of the port: checkpoint -> consensus params ->
engine -> traffic.

The port of ``repro.launch.serve``, with the same flags and behaviour: it
serves ``smoke_variant(get_config(arch))``.

  * params: ``--ckpt-dir`` loads a trainer checkpoint (of either package)
    through :func:`repro_torch.serve.consensus.consensus_params` (the
    node-averaged x̄, with per-node disagreement printed), otherwise random
    init from ``--seed``; on ``--device`` (``cuda`` unless asked for the
    CPU; without a card and without ``--device cpu`` it raises),
  * engine: ``--engine resident`` (device-resident chunked decode, the
    default) or ``--engine host`` (the per-token ``ContinuousBatcher``
    loop); ``--slots``/``--max-len``/``--chunk`` size the shared cache,
  * traffic: ``--stream`` replays a seeded synthetic workload
    (``repro_torch.serve.stream``) against the wall clock and reports
    TTFT/TPOT percentiles + sustained tokens/s; without it, one fixed
    batch of prompts is served closed-loop,
  * a warm-up run (kernel builds, library start-up) precedes any timing.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 50 --ckpt-dir /tmp/run0 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --ckpt-dir /tmp/run0 --stream --requests 32 --slots 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _build_params(args, cfg):
    from repro_torch.models import transformer
    from repro_torch.serve import consensus

    if args.ckpt_dir:
        params, info = consensus.consensus_params(args.ckpt_dir, cfg,
                                                  device=args.device)
        print(info)
        return params
    return transformer.init_params(cfg, args.seed, device=args.device)


def _build_backend(args, cfg, params):
    from repro_torch.serve.engine import ResidentEngine
    from repro_torch.serve.scheduler import ContinuousBatcher
    from repro_torch.serve.stream import HostBatcherDriver

    if args.engine == "resident":
        return ResidentEngine(cfg, params, max_slots=args.slots,
                              max_len=args.max_len, chunk=args.chunk)
    return HostBatcherDriver(ContinuousBatcher(
        cfg, params, max_slots=args.slots, max_len=args.max_len))


def _sync(params):
    if params["embed"].device.type == "cuda":
        torch.cuda.synchronize(params["embed"].device)


def _warm(args, cfg, params, prompt_lens):
    """Run every prompt length once before any timing."""
    from repro_torch.serve.scheduler import Request

    t0 = time.perf_counter()
    warm = _build_backend(args, cfg, params)
    rng = np.random.default_rng(0)
    for i, plen in enumerate(sorted(set(int(p) for p in prompt_lens))):
        warm.submit(Request(uid=-1 - i, tokens=rng.integers(
            0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=2))
    while warm.busy:
        warm.step()
    _sync(params)
    return time.perf_counter() - t0


def main(argv=None):
    from repro_torch import configs
    from repro_torch.serve import metrics as metrics_lib
    from repro_torch.serve import stream as stream_lib
    from repro_torch.serve.scheduler import Request

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--ckpt-dir", default="",
                    help="load consensus params from a trainer checkpoint")
    ap.add_argument("--engine", default="resident",
                    choices=["resident", "host"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per chunk (resident)")
    ap.add_argument("--stream", action="store_true",
                    help="replay a seeded synthetic arrival stream instead "
                         "of one fixed batch")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=64.0,
                    help="stream mean arrivals/s")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "batch"])
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.smoke_variant(configs.get_config(args.arch))
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch}: serve drives the token path; pick "
                         "a text arch")
    params = _build_params(args, cfg)
    where = str(params["embed"].device)

    if args.stream:
        sc = stream_lib.StreamConfig(
            num_requests=args.requests, vocab_size=cfg.vocab_size,
            arrival=args.arrival, rate=args.rate,
            prompt_lens=(args.prompt_len // 2 or 1, args.prompt_len),
            new_low=max(args.new // 2, 1), new_high=args.new,
            seed=args.seed)
        requests = stream_lib.make_requests(sc)
        t_warm = _warm(args, cfg, params, sc.prompt_lens)
        backend = _build_backend(args, cfg, params)
        timings = stream_lib.replay(backend, requests)
        summary = metrics_lib.summarize(timings)
        print(f"arch={args.arch} (smoke) device={where} "
              f"engine={args.engine} slots={args.slots} "
              f"stream={args.arrival}@{args.rate}/s "
              f"(warmup {t_warm*1e3:.0f} ms, untimed)")
        print(f"  {summary['requests']} requests, {summary['tokens']} "
              f"tokens in {summary['span_s']*1e3:.1f} ms: "
              f"{summary['tokens_per_s']:.1f} tok/s "
              f"({summary['ms_per_token']:.3f} ms/tok)")
        for k in ("ttft_ms", "tpot_ms"):
            p = summary[k]
            print(f"  {k:8s} p50 {p['p50']:8.2f}  p95 {p['p95']:8.2f}  "
                  f"p99 {p['p99']:8.2f}")
        return summary

    # fixed closed-loop batch: submit everything at t=0, drain
    t_warm = _warm(args, cfg, params, [args.prompt_len])
    backend = _build_backend(args, cfg, params)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        backend.submit(Request(
            uid=uid, tokens=rng.integers(0, cfg.vocab_size,
                                         size=args.prompt_len)
            .astype(np.int32), max_new_tokens=args.new))
    t0 = time.perf_counter()
    while backend.busy:
        backend.step()
    _sync(params)
    span = time.perf_counter() - t0
    total = sum(len(v) for v in backend.outputs.values())
    print(f"arch={args.arch} (smoke) device={where} engine={args.engine} "
          f"slots={args.slots}: {args.requests} requests, {total} tokens "
          f"in {span*1e3:.1f} ms (warmup {t_warm*1e3:.0f} ms, untimed)")
    print(f"  {total/span:.1f} tok/s ({span*1e3/total:.3f} ms/tok)")
    sample = backend.outputs[0]
    print("sample:", np.asarray(sample)[:16].tolist())
    return {"requests": args.requests, "tokens": total, "span_s": span,
            "tokens_per_s": total / span,
            "ms_per_token": span * 1e3 / total}


if __name__ == "__main__":
    main()
