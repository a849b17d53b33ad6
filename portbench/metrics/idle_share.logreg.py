"""The share of the traced window in which no operation ran on the card:
1 - the union of the device's operation intervals over the window's wall
time.  Moves ``logreg_epochs_per_s``."""

READS = ("device trace: every kernel, copy and fill",)


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return max(0.0, 1.0 - t.busy_s / t.window_s) * 100
