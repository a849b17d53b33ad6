"""The share of the traced window's decode chunks that the serving engine
replayed as its CUDA graph: the program's ``engine.decode_chunk`` spans
(``serve/engine.py``) that hold an ``engine.replay`` span, over all of
them, in %.  100 where every chunk replays the graph that set-up's first
chunk captured; 0 where the chunks run eagerly (a program without the
graph, or an engine that falls back).  Moves ``ttft_p95_ms``: a replayed
chunk is issued by one launch, where an eager one issues every kernel from
the host, and a request waits for the chunk in flight before its
prefill."""

import bisect

READS = ("program span engine.decode_chunk", "program span engine.replay")


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.host_count("engine.decode_chunk"):
        return None
    starts = sorted(s for n, s, _ in t.host_spans if n == "engine.replay")
    chunks = [(s, e) for n, s, e in t.host_spans
              if n == "engine.decode_chunk"]
    held = sum(1 for s, e in chunks
               if bisect.bisect_right(starts, e) > bisect.bisect_left(
                   starts, s))
    return held / len(chunks) * 100
