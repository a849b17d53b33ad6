"""Serving under an open loop: the program's ``serve.engine.ResidentEngine``
(continuous batching, device-resident decode chunks) fed requests at the
times they are due.

Traffic parameters: ``rate`` (requests a second, Poisson), ``prompt``
(log-normal ``median``, ``sigma``, clipped to ``min`` .. ``max``),
``new_tokens`` (``min`` .. ``max``, greedy, no EOS), ``slots``, ``chunk``,
``max_len``, ``drain_s`` (how long the window's last requests may take
after it closes), ``warm_prompts`` (prompt lengths warmed up in set-up),
``trace_seconds`` (the window of a traced run) and ``limits``.

Requests are submitted when due; each ``engine.step()`` admits queued
requests (a prefill each), runs one decode chunk and pulls its tokens.
A request's first token is seen when the step that emitted it returns.
``ttft_p95_ms`` is over every request due in the window, timed from when
it was due; a request with no first token when the drain ends is a miss.

The reference reruns every finished request over its prompt and served
tokens, and the widest gap by which a served token's logit lies below the
reference's best decides ``correct``: a prefill's first token and each
cached decode step's, through the flash and RMSNorm kernels and the
engine's cache."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..frozen import counts, serving
from ..frozen.peaks import least_seconds
from ..harness import Outcome
from . import datasets, lm_common


def run(r) -> Outcome:
    from repro_torch.serve.engine import ResidentEngine
    from repro_torch.serve.scheduler import Request

    cfg, mix, dev = r.config, r.traffic, r.device
    model = cfg["model"]
    mc = lm_common.program_config(cfg, kernels=True)
    params = lm_common.make_weights(model, r.seed, dev)
    engine = ResidentEngine(mc, params, max_slots=mix["slots"],
                            max_len=mix["max_len"], chunk=mix["chunk"])

    # set-up: every prompt length bucket the mix reaches, and full decode
    gen = datasets.generator(r.seed, dev, 13)
    for i, n in enumerate(mix["warm_prompts"]):
        toks = torch.randint(0, model["vocab_size"], (n,), generator=gen,
                             device=dev).cpu().numpy().astype(np.int32)
        engine.submit(Request(uid=-1 - i, tokens=toks,
                              max_new_tokens=2 * mix["chunk"]))
    engine.run_until_done()
    engine.outputs.clear()

    window = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    reqs = serving.make_requests(mix, r.seed, window, model["vocab_size"])
    timings = {q.uid: serving.Timing(q.uid, q.due) for q in reqs}
    prompt_len = {q.uid: len(q.tokens) for q in reqs}
    budget = {q.uid: q.max_new_tokens for q in reqs}
    emitted = {q.uid: 0 for q in reqs}
    r.setup_done()

    tracer = None
    if r.trace:
        from ..trace import Tracer
        tracer = Tracer(dev)
        tracer.__enter__()
    least = 0.0
    chunk_ms = []
    t0 = time.perf_counter()
    nxt, deadline = 0, window + mix["drain_s"]
    while True:
        now = time.perf_counter() - t0
        while nxt < len(reqs) and reqs[nxt].due <= now:
            q = reqs[nxt]
            engine.submit(Request(uid=q.uid, tokens=q.tokens,
                                  max_new_tokens=q.max_new_tokens))
            nxt += 1
        if engine.busy:
            admitted = engine.transfers["h2d"]
            t_a = time.perf_counter()
            with r.span("bench.engine_step"):
                events = engine.step()
            t_b = time.perf_counter()
            tnow = t_b - t0
            if engine.transfers["h2d"] == admitted:
                chunk_ms.append((t_b - t_a) * 1e3)
            rows = []
            for uid, k in events.items():
                tm = timings[uid]
                if tm.first_token is None:
                    tm.first_token = tnow
                    pf, pb = counts.lm_prefill(model, prompt_len[uid])
                    least += least_seconds(pf, pb)
                e = emitted[uid]
                rows += [prompt_len[uid] + j - 1
                         for j in range(e + 1, e + k + 1) if j < budget[uid]]
                emitted[uid] = e + k
                tm.n_tokens = e + k
            if rows:
                least += least_seconds(*counts.lm_decode(model, rows))
            for uid in list(engine.outputs):
                if uid in timings and timings[uid].done is None:
                    timings[uid].done = tnow
        elif nxt >= len(reqs):
            break
        else:
            time.sleep(max(0.0, min(reqs[nxt].due - now, 0.002)))
        if now > deadline:
            break
    r.sync()
    if tracer is not None:
        tracer.__exit__(None, None, None)
    peak = r.memory_peak()
    outputs = {uid: np.asarray(v) for uid, v in engine.outputs.items()
               if uid in timings}
    del engine

    for uid, tm in timings.items():
        if tm.first_token is None:
            tm.failed = True
    summary = serving.summarize(list(timings.values()))
    halves = [[t for t in timings.values() if (t.due < window / 2) == first]
              for first in (True, False)]
    summary["ttft_p50_ms_halves"] = [
        serving.summarize(h)["ttft_p50_ms"] if h else None for h in halves]
    work = {"least_s": least, "chunk_ms": chunk_ms, "summary": summary,
            "prefill_attention": [
                (counts.attention_core_flops(model, prompt_len[u]),
                 counts.attention_core_bytes(model, prompt_len[u]))
                for u, tm in timings.items() if tm.first_token is not None]}

    checks = r.checks()
    checks.add("length_mismatch", float(sum(
        1 for uid, out in outputs.items() if len(out) != budget[uid])))
    prompts = {q.uid: q.tokens for q in reqs}
    gap, controls = _logit_gaps(model, params, prompts, outputs,
                                mix.get("controls", ()))
    checks.add("logit_gap", gap)
    return Outcome(e2e={"ttft_p95_ms": summary["ttft_p95_ms"]},
                   attempted=len(reqs), failed=summary["misses"],
                   checks=checks, work=work, counters={},
                   memory_peak_bytes=peak,
                   trace=None if tracer is None else tracer.result,
                   controls=controls)


@torch.no_grad()
def _logit_gaps(model, params, prompts, outputs, controls):
    """The widest gap, over every finished request's served tokens, by
    which the served token's logit lies below the reference's best; and for
    each control precision, the same gap of the token that the control
    puts first at the same positions."""
    from reference import dense_lm
    from reference.numerics import Precision

    if not outputs:
        return float("inf"), {}
    widest = 0.0
    ctl = {name: 0.0 for name in controls}
    for uid in sorted(outputs):
        served = outputs[uid]
        T = len(prompts[uid])
        seq = np.concatenate([prompts[uid], served[:-1]]).astype(np.int64)
        toks = torch.as_tensor(seq, device=params["embed"].device)[None]
        at = dense_lm.forward(params, model, toks)[0, T - 1:]
        best = at.max(dim=-1).values

        def gap(tgt):
            return float((best - at.gather(1, tgt[:, None])[:, 0]).max())

        widest = max(widest, gap(torch.as_tensor(served.astype(np.int64),
                                                 device=at.device)))
        for name in controls:
            low = dense_lm.forward(params, model, toks, Precision(name))
            ctl[name] = max(ctl[name], gap(low[0, T - 1:].argmax(dim=-1)))
            del low
        del at
    return widest, {name: {"logit_gap": {"value": v}}
                    for name, v in ctl.items()}
