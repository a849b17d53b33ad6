"""The device's idle time by the innermost host span open at the middle
of each gap, as ``Trace.idle_by_host`` labels it, in one sweep.

``idle_by_host`` scans the spans, shortest first, for every gap: with the
program's serving spans (about 1,500 in a traced serving window, ~100,000
gaps between its kernels) that takes tens of seconds a call.  Here the
gaps' middles, which rise, meet the spans in order of their start, and a
heap keyed as ``idle_by_host`` sorts (length, name, start, end) gives the
innermost open span: the same labels and seconds, in
O((gaps + spans) log spans)."""

from __future__ import annotations

import heapq
from collections import defaultdict

from .trace import WINDOW_SPAN

OUTSIDE = "host outside any span"


def idle_by_span(trace) -> dict:
    """{label: idle seconds} of ``trace`` (a ``trace.Trace``)."""
    spans = sorted((s, e, n) for n, s, e in trace.host_spans
                   if n != WINDOW_SPAN)
    edges = [trace.start_ns] + [x for iv in trace.busy_intervals
                                for x in iv] + [trace.end_ns]
    out = defaultdict(float)
    heap, i = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(spans) and spans[i][0] <= mid:
            s, e, n = spans[i]
            heapq.heappush(heap, (e - s, n, s, e))
            i += 1
        while heap and heap[0][3] < mid:      # closed before this gap
            heapq.heappop(heap)
        out[heap[0][1] if heap else OUTSIDE] += (b - a) / 1e9
    return dict(out)
