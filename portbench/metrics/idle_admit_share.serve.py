"""The share of the traced serving window in which the card sat idle
while the host was admitting: the device's idle gaps whose innermost open
program span is ``engine.admit`` or one of its parts (``engine.upload``,
``engine.prefill``, ``engine.splice``), over the window's wall time.  The
same unit and window as ``idle_share.serve``, which it and
``idle_chunk_share.serve`` split.  Moves ``ttft_p95_ms``."""

from pbcore.idle import idle_by_span

READS = ("device trace: idle gaps by the innermost program span",
         "program spans engine.admit, engine.upload, engine.prefill, "
         "engine.splice")

SPANS = ("engine.admit", "engine.upload", "engine.prefill", "engine.splice")


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device_ops \
            or not t.host_count("engine.admit"):
        return None
    idle = idle_by_span(t)
    return sum(idle.get(n, 0.0) for n in SPANS) / t.window_s * 100
