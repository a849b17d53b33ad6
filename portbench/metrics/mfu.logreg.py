"""The whole grid's share of the card's peak: the least time the traced
grids' work needs (``frozen.counts.logreg_grid``: each step, refresh and
record bounded by its operations at 495 TFLOP/s or its bytes at 3.35
TB/s) over the traced window's wall time.  Moves
``logreg_epochs_per_s``."""

READS = ("harness count of grids", "traced window's wall time")


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0:
        return None
    return ctx["work"]["least_s"] / t.window_s * 100
