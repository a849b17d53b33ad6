"""The port's serving bench: the host ``ContinuousBatcher`` against the
device-resident ``ResidentEngine`` under a sustained synthetic stream,
plus prefill/decode split timings at the tiny and smoke-LM shapes.  The
twin of ``benchmarks/serve_bench.py``, with its model, stream, slots,
``max_len``, chunk and shapes.

    python -m benchmarks.pt_serve_bench [--device cuda|cpu] [--iters N]
    python -m benchmarks.pt_serve_bench --json [PATH]

* **host vs resident ms/token**: both backends replay the SAME seeded
  request stream (``repro_torch.serve.stream``, Poisson arrivals fast
  enough to saturate the slots), best of ``--iters``.  The bench ASSERTS
  the two backends' per-request outputs are bit-identical (each cache
  row's decode is independent of its neighbours, so residency must not
  change a token) and that the engine's transfer ledger is O(1) per chunk:
  one upload per admission (the prompt), one pull per chunk (the emission
  buffer), against the host loop's per-token syncs.
* **sustained-traffic percentiles**: TTFT / TPOT p50, p95 and p99 and
  tokens/s of the resident engine under the stream
  (``repro_torch.serve.metrics``).
* **prefill/decode split**: a warmed ``transformer.prefill`` and a decode
  step, timed apart (the device synchronized around each), at the tiny
  shape (1 layer, d16: dispatch-bound) and the smoke-LM shape
  (h2o-danube-1.8b's smoke variant, with the RMSNorm and flash attention
  kernels on: on the card they launch).

Runs on the CUDA device unless given ``--device cpu``; without a card it
raises.  ``--json`` MERGES a ``"serve"`` section into PATH (default
``BENCH_torch.json``) and keeps its other sections.  Like the reference's,
it is not one of ``benchmarks.pt_run``'s suites.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import pt_common as common
from repro_torch.models import transformer
from repro_torch.models.api import ModelConfig
from repro_torch.serve import metrics as metrics_lib
from repro_torch.serve import stream as stream_lib
from repro_torch.serve.engine import ResidentEngine
from repro_torch.serve.scheduler import ContinuousBatcher

# dispatch-overhead-dominated shape (the runner bench's bench-lm): the
# residency win is per-token host overhead, so per-token compute must not
# swamp it
TINY = ModelConfig(name="bench-lm", arch_type="dense", num_layers=1,
                   d_model=16, num_heads=1, num_kv_heads=1, d_ff=32,
                   vocab_size=64)

_STREAM = stream_lib.StreamConfig(
    num_requests=24, vocab_size=TINY.vocab_size, arrival="poisson",
    rate=2000.0,                      # saturating: arrivals never throttle
    prompt_lens=(8, 16), new_low=8, new_high=24, seed=0)
_SLOTS, _MAX_LEN, _CHUNK = 4, 64, 8


def _smoke_cfg() -> ModelConfig:
    from repro_torch import configs
    return configs.smoke_variant(configs.get_config(
        "h2o-danube-1.8b")).scaled(use_flash=True, use_fused_norm=True)


def _make_backend(resident: bool, cfg, params):
    if resident:
        return ResidentEngine(cfg, params, max_slots=_SLOTS,
                              max_len=_MAX_LEN, chunk=_CHUNK)
    return stream_lib.HostBatcherDriver(ContinuousBatcher(
        cfg, params, max_slots=_SLOTS, max_len=_MAX_LEN))


def _replay_once(resident: bool, cfg, params, requests):
    backend = _make_backend(resident, cfg, params)
    timings = stream_lib.replay(backend, requests)
    return metrics_lib.summarize(timings), backend


@torch.no_grad()
def prefill_decode_split(cfg, device, *, batch: int, prompt_len: int,
                         iters: int = 5) -> dict:
    """Warmed prefill ms and decode ms/token at one shape, best of
    ``iters``."""
    params = transformer.init_params(cfg, 0, device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32),
        device=device)

    def prefill():
        return transformer.prefill(cfg, params, toks, max_len=_MAX_LEN)

    logits, cache = prefill()                                   # warm
    common.sync(device)
    best_p = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        prefill()
        common.sync(device)
        best_p = min(best_p, time.perf_counter() - t0)

    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    # decode from fresh copies of the prefill's cache: each timed run
    # decodes the same positions (decode_step updates the KV in place)
    fresh = lambda: pytree.tree_map(torch.clone, cache)
    transformer.decode_step(cfg, params, fresh(), cur)             # warm
    common.sync(device)
    n_dec = 16
    best_d = float("inf")
    for _ in range(iters):
        c = fresh()
        common.sync(device)
        t0 = time.perf_counter()
        for _ in range(n_dec):
            _, c = transformer.decode_step(cfg, params, c, cur)
        common.sync(device)
        best_d = min(best_d, time.perf_counter() - t0)

    return {"batch": batch, "prompt_len": prompt_len,
            "prefill_ms": best_p * 1e3,
            "decode_ms_per_token": best_d * 1e3 / n_dec}


def serve_stats(device="cuda", iters: int = 3) -> dict:
    """Host vs resident under the stream, and the prefill/decode split."""
    device = common.require_device(device)
    params = transformer.init_params(TINY, 0, device)
    requests = stream_lib.make_requests(_STREAM)

    # warm both backends before any timing
    host_sum, host_backend = _replay_once(False, TINY, params, requests)
    res_sum, res_backend = _replay_once(True, TINY, params, requests)

    # residency must not change a single token: bit-identical outputs
    host_out = host_backend.outputs
    res_out = res_backend.outputs
    assert set(host_out) == set(res_out), (set(host_out), set(res_out))
    outputs_equal = all(np.array_equal(host_out[u], res_out[u])
                        for u in host_out)
    assert outputs_equal, "resident engine diverged from host batcher"

    # O(1) transfers per chunk: one prompt upload per admission, one
    # emission-buffer pull per chunk, independent of tokens x slots
    tr = res_backend.transfers
    assert tr["d2h"] == tr["chunks"], tr
    assert tr["h2d"] == len(requests), (tr, len(requests))

    best_host = host_sum
    best_res = res_sum
    for _ in range(iters):
        s, _ = _replay_once(False, TINY, params, requests)
        if s["ms_per_token"] < best_host["ms_per_token"]:
            best_host = s
        s, _ = _replay_once(True, TINY, params, requests)
        if s["ms_per_token"] < best_res["ms_per_token"]:
            best_res = s

    return {
        "device": str(device),
        "model": "lm1x16_v64", "slots": _SLOTS, "max_len": _MAX_LEN,
        "chunk": _CHUNK,
        "stream": {"requests": _STREAM.num_requests,
                   "arrival": _STREAM.arrival, "rate": _STREAM.rate,
                   "prompt_lens": list(_STREAM.prompt_lens),
                   "new": [_STREAM.new_low, _STREAM.new_high],
                   "tokens": best_res["tokens"]},
        "host_ms_per_token": best_host["ms_per_token"],
        "resident_ms_per_token": best_res["ms_per_token"],
        "speedup_resident_vs_host": (best_host["ms_per_token"]
                                     / best_res["ms_per_token"]),
        "resident_tokens_per_s": best_res["tokens_per_s"],
        "ttft_ms": best_res["ttft_ms"],
        "tpot_ms": best_res["tpot_ms"],
        "transfers": {"resident": [tr["h2d"], tr["d2h"]],
                      "chunks": tr["chunks"],
                      "admissions": len(requests)},
        "outputs_equal": bool(outputs_equal),
        "prefill_decode": {
            "tiny": prefill_decode_split(TINY, device, batch=1,
                                         prompt_len=16),
            "lm": prefill_decode_split(_smoke_cfg(), device, batch=1,
                                       prompt_len=32),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--json", nargs="?", const="BENCH_torch.json",
                    default=None, metavar="PATH",
                    help="MERGE the stats as a 'serve' section into PATH "
                         "(default BENCH_torch.json), keeping its other "
                         "sections")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    ss = serve_stats(args.device, iters=args.iters)
    if args.json:
        out = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                out = json.load(f)
        out["serve"] = ss
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json} (serve section, device {ss['device']})")
    print(f"  serve       host={ss['host_ms_per_token']:.3f} "
          f"resident={ss['resident_ms_per_token']:.3f} ms/token "
          f"({ss['speedup_resident_vs_host']:.1f}x, "
          f"{ss['resident_tokens_per_s']:.0f} tok/s, transfers "
          f"{ss['transfers']['resident']} over "
          f"{ss['transfers']['chunks']} chunks)")
    print(f"  ttft p50/p95/p99 = {ss['ttft_ms']['p50']:.2f}/"
          f"{ss['ttft_ms']['p95']:.2f}/{ss['ttft_ms']['p99']:.2f} ms; "
          f"tpot p50/p95/p99 = {ss['tpot_ms']['p50']:.2f}/"
          f"{ss['tpot_ms']['p95']:.2f}/{ss['tpot_ms']['p99']:.2f} ms")
    for shape, pd in ss["prefill_decode"].items():
        print(f"  prefill/{shape:4s} {pd['prefill_ms']:.3f} ms "
              f"(prompt={pd['prompt_len']}), decode "
              f"{pd['decode_ms_per_token']:.3f} ms/token")
    return ss


if __name__ == "__main__":
    main()
