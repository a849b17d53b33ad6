"""The 95th percentile of time per output token after the first, over the
traced window's requests (``frozen.serving.summarize``: a request not
finished by the drain's end reads infinite).  Moves ``ttft_p95_ms``: the
slots a slow decode holds are slots a new request waits for."""

import math

READS = ("per-request first-token and completion times",)


def read(ctx):
    s = ctx["work"].get("summary")
    if not s or not math.isfinite(s["tpot_p95_ms"]):
        return None
    return s["tpot_p95_ms"]
