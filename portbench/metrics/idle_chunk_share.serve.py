"""The share of the traced serving window in which the card sat idle
while the host was issuing a decode chunk: the device's idle gaps whose
innermost open program span is ``engine.decode_chunk``, over the window's
wall time.  The same unit and window as ``idle_share.serve``, which it and
``idle_admit_share.serve`` split.  Moves ``ttft_p95_ms``."""

from pbcore.idle import idle_by_span

READS = ("device trace: idle gaps by the innermost program span",
         "program span engine.decode_chunk")


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device_ops \
            or not t.host_count("engine.decode_chunk"):
        return None
    return idle_by_span(t).get("engine.decode_chunk", 0.0) \
        / t.window_s * 100
