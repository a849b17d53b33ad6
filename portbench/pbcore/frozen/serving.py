"""Open-loop requests and their latency summary.

``make_requests`` follows the program's ``serve/stream.make_requests``:
counter-based draws from ``np.random.default_rng([seed, salt, uid])``, so
request ``i`` is a pure function of the seed and ``i``.  It departs from
it in two ways.  Prompt lengths come from a continuous log-normal, not
from a few buckets (the reference bounded JAX compiles with them; the port
compiles nothing per shape).  And the window's requests hold one fixed set
of prompt lengths, output lengths and gaps, the quantiles of their
distributions, in an order drawn from the seed: every seed gives the card
the same work, in another order.  The order is stratified: the quantiles
fall into ``STRATUM`` bands of neighbouring ranks, and each block of
``STRATUM`` consecutive requests takes one from each band, so that the
longest prompts cannot bunch in one seed's order and not in another's
(at 0.8 of the knee the tail moves with such bunches).

``summarize`` follows ``serve/metrics.summarize`` with two corrections: a
request that failed or had no first token by the end of the drain counts
as a miss, its latency infinite, and every percentile is over all the
requests that were due, not over the finished ones.  Percentiles are by
nearest rank, which is defined with misses among the values."""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

STRATUM = 20
_ORDER_SALT = 0x51
_TOKENS_SALT = 0x53


@dataclasses.dataclass
class StreamRequest:
    uid: int
    due: float               # seconds from the window's start
    tokens: np.ndarray       # (L,) int32 prompt
    max_new_tokens: int


@dataclasses.dataclass
class Timing:
    uid: int
    due: float
    first_token: float | None = None
    done: float | None = None
    n_tokens: int = 0
    failed: bool = False


def quantile_lengths(n: int, median: float, sigma: float, low: int,
                     high: int) -> list:
    """n log-normal prompt lengths at the quantiles (i + 0.5) / n, clipped
    to [low, high]."""
    z = NormalDist()
    return [int(min(max(round(median * math.exp(sigma * z.inv_cdf(
        (i + 0.5) / n))), low), high)) for i in range(n)]


def stratified_order(n: int, stratum: int, rng) -> list:
    """A permutation of the ranks 0..n-1 in blocks of ``stratum`` places,
    each of which takes one rank from each band of ``ceil(n / stratum)``
    neighbouring ranks (fewer where the last bands run short of ranks), so
    no ``stratum`` consecutive places hold more than two of one band."""
    nb = -(-n // stratum)
    picks = [rng.permutation(nb) for _ in range(stratum)]
    order = []
    for b in range(nb):
        block = [s * nb + int(picks[s][b]) for s in range(stratum)
                 if s * nb + int(picks[s][b]) < n]
        order += [block[i] for i in rng.permutation(len(block))]
    return order


def make_requests(mix: dict, seed: int, seconds: float,
                  vocab_size: int) -> list:
    """The requests due in a window of ``seconds`` at ``mix['rate']`` per
    second: Poisson gaps (exponential quantiles), log-normal prompts, a
    uniform spread of output lengths, each in a stratified order of its
    own drawn from the seed."""
    rate = float(mix["rate"])
    n = max(int(round(rate * seconds)), 1)
    p = mix["prompt"]
    lens = quantile_lengths(n, p["median"], p["sigma"], p["min"], p["max"])
    lo, hi = mix["new_tokens"]["min"], mix["new_tokens"]["max"]
    news = [lo + int((i + 0.5) / n * (hi - lo + 1)) for i in range(n)]
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    orders = [stratified_order(n, STRATUM, np.random.default_rng(
        [seed, _ORDER_SALT, k])) for k in range(3)]
    out, t = [], 0.0
    for i in range(n):
        t += gaps[orders[0][i]]
        plen = lens[orders[1][i]]
        toks = np.random.default_rng([seed, _TOKENS_SALT, i]).integers(
            0, vocab_size, size=plen).astype(np.int32)
        out.append(StreamRequest(uid=i, due=t, tokens=toks,
                                 max_new_tokens=news[orders[2][i]]))
    return out


def nearest_rank(values, pct: float) -> float:
    """The pct-th percentile by nearest rank (inf among the values is a
    miss)."""
    arr = np.sort(np.asarray(values, np.float64))
    if arr.size == 0:
        raise ValueError("no values")
    k = max(int(math.ceil(pct / 100.0 * arr.size)), 1)
    return float(arr[k - 1])


def summarize(timings: list) -> dict:
    """TTFT from when each request was due, TPOT after the first token; a
    request with no first token (failed, or unfinished at the drain's end)
    is a miss, at infinity."""
    if not timings:
        raise ValueError("no requests were due")
    ttft, tpot, misses = [], [], 0
    for t in timings:
        if t.failed or t.first_token is None:
            ttft.append(math.inf)
            misses += 1
        else:
            ttft.append((t.first_token - t.due) * 1e3)
        if t.done is not None and not t.failed and t.n_tokens > 1:
            tpot.append((t.done - t.first_token) / (t.n_tokens - 1) * 1e3)
        elif t.done is None or t.failed:
            tpot.append(math.inf)
    finished = [t for t in timings if t.done is not None and not t.failed]
    return {"requests": len(timings), "finished": len(finished),
            "misses": misses,
            "ttft_p50_ms": nearest_rank(ttft, 50),
            "ttft_p95_ms": nearest_rank(ttft, 95),
            "tpot_p50_ms": nearest_rank(tpot, 50) if tpot else math.inf,
            "tpot_p95_ms": nearest_rank(tpot, 95) if tpot else math.inf,
            "tokens": int(sum(t.n_tokens for t in finished))}
