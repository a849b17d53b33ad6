"""Seeded synthetic request workloads + the replay loop.

The port of ``repro.serve.stream`` (host numpy code): ``make_requests``
gives the reference's streams bit for bit for the same ``StreamConfig``.

``make_requests`` generates the "millions of users" traffic shape at bench
scale: request arrivals (Poisson or bursty), prompt lengths drawn from a
small bucket set (bounding prefill compiles — each distinct length is one
executable), output budgets from a uniform range, and random prompt
tokens.  Every per-request draw comes from a counter-based
``np.random.default_rng([seed, salt, uid])`` stream in the
counter-based style: request ``i`` is a pure function of
``(seed, i)`` independent of generation order, so truncating or extending
a stream never reshuffles the requests it shares with another run.

``replay`` plays a stream through any serving backend (the device-resident
:class:`~repro_torch.serve.engine.ResidentEngine` or the host
:class:`~repro_torch.serve.scheduler.ContinuousBatcher` via
:class:`HostBatcherDriver`) against the wall clock: requests are submitted
when their arrival offset passes, and per-request TTFT / completion
timestamps are recorded for :func:`repro_torch.serve.metrics.summarize`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np

from .metrics import RequestTiming
from .scheduler import ContinuousBatcher, Request

__all__ = ["StreamConfig", "StreamRequest", "make_requests",
           "HostBatcherDriver", "replay"]

# stream salts: each draw kind has its own counter-based stream so e.g.
# changing the arrival model never reshuffles prompt contents
_ARRIVAL_SALT = 0x51
_PROMPT_LEN_SALT = 0x52
_TOKENS_SALT = 0x53
_BUDGET_SALT = 0x54


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    num_requests: int = 32
    vocab_size: int = 512
    arrival: str = "poisson"        # poisson | bursty | batch (all at t=0)
    rate: float = 32.0              # mean arrivals per second
    burst: int = 4                  # bursty: requests per burst
    prompt_lens: tuple = (8, 16, 32)  # bucket set (bounds prefill compiles)
    new_low: int = 4                # output budget ~ U[new_low, new_high]
    new_high: int = 24
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty", "batch"):
            raise ValueError(f"unknown arrival model {self.arrival!r}")
        if self.num_requests < 1 or self.rate <= 0 or self.burst < 1:
            raise ValueError("num_requests/rate/burst must be positive")
        if not (1 <= self.new_low <= self.new_high):
            raise ValueError("need 1 <= new_low <= new_high")


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    uid: int
    arrival: float                  # seconds from stream start
    tokens: np.ndarray              # (L,) int32 prompt
    max_new_tokens: int

    def to_request(self) -> Request:
        return Request(uid=self.uid, tokens=self.tokens,
                       max_new_tokens=self.max_new_tokens)


def _gap(sc: StreamConfig, i: int) -> float:
    """Inter-arrival gap in front of request i (counter-based draw)."""
    rng = np.random.default_rng([sc.seed, _ARRIVAL_SALT, i])
    if sc.arrival == "batch":
        return 0.0
    if sc.arrival == "poisson":
        return float(rng.exponential(1.0 / sc.rate))
    # bursty: `burst` requests land together; the gap in front of each
    # burst keeps the long-run rate at `rate`
    if i % sc.burst:
        return 0.0
    return float(rng.exponential(sc.burst / sc.rate))


def make_requests(sc: StreamConfig) -> "list[StreamRequest]":
    out, t = [], 0.0
    for i in range(sc.num_requests):
        t += _gap(sc, i)
        plen = int(np.random.default_rng(
            [sc.seed, _PROMPT_LEN_SALT, i]).choice(np.asarray(
                sc.prompt_lens)))
        toks = np.random.default_rng([sc.seed, _TOKENS_SALT, i]).integers(
            0, sc.vocab_size, size=plen).astype(np.int32)
        budget = int(np.random.default_rng(
            [sc.seed, _BUDGET_SALT, i]).integers(sc.new_low,
                                                 sc.new_high + 1))
        out.append(StreamRequest(uid=i, arrival=t, tokens=toks,
                                 max_new_tokens=budget))
    return out


class HostBatcherDriver:
    """Adapts :class:`ContinuousBatcher` to the replay protocol
    (``submit`` / ``busy`` / ``step() -> {uid: n_new}`` / ``outputs``) by
    diffing per-slot emission counts around one host decode step."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher

    def submit(self, req: Request):
        self.batcher.submit(req)

    @property
    def busy(self) -> bool:
        return self.batcher.busy

    @property
    def outputs(self) -> dict:
        return self.batcher.outputs

    def step(self) -> dict[int, int]:
        b = self.batcher
        before = {r.uid: len(b.slot_generated[s])
                  for s, r in enumerate(b.slot_req) if r is not None}
        done_before = set(b.outputs)
        b.step()
        events: dict[int, int] = {}
        for s, r in enumerate(b.slot_req):
            if r is not None:
                n = len(b.slot_generated[s]) - before.get(r.uid, 0)
                if n:
                    events[r.uid] = n
        for uid in set(b.outputs) - done_before:
            n = len(b.outputs[uid]) - before.get(uid, 0)
            if n:
                events[uid] = n
        return events


def replay(backend, requests: Iterable[StreamRequest], *,
           timer=time.perf_counter,
           max_steps: int = 100_000) -> "list[RequestTiming]":
    """Play ``requests`` through ``backend`` against the wall clock.

    Arrival offsets are wall-clock seconds from replay start; a request is
    submitted at the first engine iteration after its offset passes (an
    open-loop stream: the generator never waits for the server, which is
    what "sustained traffic" means).  Returns per-request timings for
    :func:`repro_torch.serve.metrics.summarize`.
    """
    pending = sorted(requests, key=lambda r: (r.arrival, r.uid))
    timings = {r.uid: RequestTiming(uid=r.uid, arrival=0.0) for r in pending}
    t0 = timer()
    steps = 0
    while (pending or backend.busy) and steps < max_steps:
        steps += 1
        now = timer() - t0
        while pending and pending[0].arrival <= now:
            r = pending.pop(0)
            timings[r.uid].arrival = max(r.arrival, 0.0)
            backend.submit(r.to_request())
        if not backend.busy:
            if pending:                      # idle until the next arrival
                time.sleep(min(pending[0].arrival - now, 0.05))
            continue
        events = backend.step()
        now = timer() - t0
        for uid, n in events.items():
            t = timings[uid]
            if t.first_token is None:
                t.first_token = now
            t.n_tokens += n
        for uid in list(backend.outputs):
            if timings[uid].done is None and uid in backend.outputs:
                timings[uid].done = now
    return [timings[uid] for uid in sorted(timings)]
