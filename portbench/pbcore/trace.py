"""A traced window: ``torch.profiler`` over part of a run, reduced to the
device's operations, the host's spans, the busy time and the idle gaps.

The busy time is the union of the intervals in which an operation (a
kernel, a copy, a fill) ran on the device; the idle share is the rest of
the traced window's wall time.  Raw kineto events are read, not the
profiler's function-event tree, which takes minutes to build over a window
of many steps."""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "bench.traced_window"


class Trace:
    def __init__(self, device_ops, host_spans, window_s, start_ns, end_ns):
        self.device_ops = device_ops      # [(name, start_ns, end_ns)], sorted
        self.host_spans = host_spans      # [(name, start_ns, end_ns)]
        self.window_s = window_s          # host clock over the traced window
        self.start_ns, self.end_ns = start_ns, end_ns
        self.busy_intervals = _union([(s, e) for _, s, e in device_ops])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e9

    def op_seconds(self, match) -> float:
        """Summed device time of the operations whose name ``match``
        accepts (a callable on the name)."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9

    def op_count(self, match) -> int:
        return sum(1 for n, _, _ in self.device_ops if match(n))

    def host_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.host_spans if n == name) / 1e9

    def host_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.host_spans if n == name)

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(int)
        for n, s, e in self.device_ops:
            by_op[n[:120]] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_by_host()[:top]]}

    def idle_by_host(self) -> list:
        """Idle seconds of the device, by the innermost host span open at
        the middle of each gap, longest first."""
        spans = sorted(((e - s, n, s, e) for n, s, e in self.host_spans
                        if n != WINDOW_SPAN))
        out = defaultdict(float)
        edges = [self.start_ns] + [x for iv in self.busy_intervals
                                   for x in iv] + [self.end_ns]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label = "host outside any span"
            for _, n, s, e in spans:          # shortest first: innermost
                if s <= mid <= e:
                    label = n
                    break
            out[label] += (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """``with Tracer() as t: ...`` traces the block; ``t.result`` is the
    :class:`Trace`.  The block's work is synchronised at both ends."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.result = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce(self._prof, window_s)
        return False


def reduce(prof, window_s: float) -> Trace:
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in events:
        if e.device_type() == cpu:
            if e.is_user_annotation():
                s = e.start_ns()
                host.append((e.name(), s, s + e.duration_ns()))
        else:
            dev.append(e)
    names = {n for n, _, _ in host}
    ops = []
    for e in dev:
        if e.is_user_annotation() or e.name() in names:
            continue                  # a span's mirror on the device's row
        s = e.start_ns()
        ops.append((e.name(), s, s + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    win = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    start_ns, end_ns = win[0] if win else (
        (ops[0][1], ops[-1][2]) if ops else (0, 0))
    return Trace(ops, host, window_s, start_ns, end_ns)
