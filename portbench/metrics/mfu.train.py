"""The training window's share of the card's peak: the least time its
steps and refreshes need (``frozen.counts.lm_dpsvrg_step`` and
``lm_refresh``: every node's gradients, backward = 2x forward, float32
products at 495 TFLOP/s; the weights' bytes at 3.35 TB/s) over the traced
window's wall time.  Moves ``train_tokens_per_s``."""

READS = ("harness count of steps and refreshes", "traced window's wall time")


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not ctx["work"].get("units"):
        return None
    return ctx["work"]["least_s"] / t.window_s * 100
