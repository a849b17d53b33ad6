"""Serving latency/throughput metrics from per-request timestamps.

The port of ``repro.serve.metrics`` (host numpy code, unchanged).

The replay loop (:func:`repro_torch.serve.stream.replay`) records one
:class:`RequestTiming` per request; :func:`summarize` reduces them to the
serving numbers that matter under sustained traffic:

* **TTFT** — time to first token, from the request's *arrival* (queueing
  included: a request waiting for a free slot pays its wait here),
* **TPOT** — time per output token after the first
  (``(done - first_token) / (n_tokens - 1)``),
* p50/p95/p99 percentiles of both,
* **sustained tokens/s** — total generated tokens over the span from the
  first arrival to the last completion (the whole-stream figure, not a
  per-request mean).

All timestamps are seconds on a common clock; reported latencies are ms.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RequestTiming", "summarize"]

_PCTS = (50, 95, 99)


@dataclasses.dataclass
class RequestTiming:
    uid: int
    arrival: float             # request entered the system
    first_token: float | None = None
    done: float | None = None
    n_tokens: int = 0


def _pct(values) -> dict:
    arr = np.asarray(values, np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in _PCTS}


def summarize(timings: "list[RequestTiming]") -> dict:
    """Reduce per-request timings to the stream-level summary dict."""
    finished = [t for t in timings if t.done is not None
                and t.first_token is not None]
    if not finished:
        raise ValueError("no finished requests to summarize")
    ttft = [(t.first_token - t.arrival) * 1e3 for t in finished]
    tpot = [(t.done - t.first_token) / max(t.n_tokens - 1, 1) * 1e3
            for t in finished]
    total_tokens = sum(t.n_tokens for t in finished)
    span = max(t.done for t in finished) - min(t.arrival for t in finished)
    return {
        "requests": len(finished),
        "tokens": int(total_tokens),
        "span_s": float(span),
        "tokens_per_s": float(total_tokens / span) if span > 0 else
        float("inf"),
        "ttft_ms": _pct(ttft),
        "tpot_ms": _pct(tpot),
        "ms_per_token": float(span * 1e3 / total_tokens),
    }
