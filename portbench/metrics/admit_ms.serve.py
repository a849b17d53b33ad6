"""Host time of one admission in the serving engine: the program's
``engine.admit`` span (``serve/engine.py``: the prompt's upload, its
prefill and the cache splice), summed over the traced window and divided
by its count.  Moves ``ttft_p95_ms``: a request's first token waits for
its admission, and every slot's next chunk waits for all of the step's."""

READS = ("program span engine.admit",)


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.host_count("engine.admit"):
        return None
    return t.host_seconds("engine.admit") / t.host_count("engine.admit") \
        * 1e3
