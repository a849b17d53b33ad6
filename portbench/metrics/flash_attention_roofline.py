"""The flash attention kernel's share of its roofline over the traced
window's prefills: the attention core's work of every prompt prefilled
(``frozen.counts.attention_core_flops``: q k^T and p v over the causal
window, float32 products at 495 TFLOP/s; its bytes at 3.35 TB/s) over the
device time of the kernels named ``flash_fwd``.  Moves ``ttft_p95_ms``."""

from pbcore.frozen.peaks import least_seconds

READS = ("device kernels named flash_fwd",
         "harness list of the window's prefills")


def _match(name):
    return "flash_fwd" in name


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.op_seconds(_match)
    work = ctx["work"].get("prefill_attention")
    if secs <= 0 or not work:
        return None
    return sum(least_seconds(f, b) for f, b in work) / secs * 100
