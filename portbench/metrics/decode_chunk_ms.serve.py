"""Wall time of an engine step that admitted nothing: one decode chunk of
every slot and its one pull (``ResidentEngine.step``), the harness's span
around the call, median over the traced window.  Moves ``ttft_p95_ms``:
a request waits for the chunk in flight before its prefill."""

import statistics

READS = ("harness span bench.engine_step, steps without an admission",)


def read(ctx):
    ms = ctx["work"].get("chunk_ms")
    return statistics.median(ms) if ms else None
