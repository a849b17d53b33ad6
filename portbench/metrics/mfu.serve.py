"""The serving window's share of the card's peak: the least time its
prefills and decode steps need (``frozen.counts.lm_prefill`` and
``lm_decode``, counting only the rows whose output is used, float32
products at 495 TFLOP/s, the weights and caches read at 3.35 TB/s) over
the traced window's wall time, drain included.  Moves ``ttft_p95_ms``."""

READS = ("harness count of prefills and decode rows",
         "traced window's wall time")


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not ctx["work"].get("least_s"):
        return None
    return ctx["work"]["least_s"] / t.window_s * 100
