"""Host time of one decode chunk's dispatch in the serving engine: the
program's ``engine.decode_chunk`` span (``serve/engine.py``: issuing the
chunk's decode steps, eagerly), summed over the traced window and divided
by its count.  Beside ``decode_chunk_ms.serve`` (the whole step, timed from
outside), it says how much of a chunk the host spends issuing it.  Moves
``ttft_p95_ms``: a request waits for the chunk in flight before its
prefill."""

READS = ("program span engine.decode_chunk",)


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.host_count("engine.decode_chunk"):
        return None
    return t.host_seconds("engine.decode_chunk") \
        / t.host_count("engine.decode_chunk") * 1e3
