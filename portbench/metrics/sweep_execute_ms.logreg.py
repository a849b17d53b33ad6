"""Host time a grid spends executing its chunks, transitions and records:
the program's ``sweep.execute`` span (``core/sweep.py``) in the traced
window, per grid.  Moves ``logreg_epochs_per_s``."""

READS = ("program span sweep.execute",)


def read(ctx):
    t, units = ctx["trace"], ctx["work"]["units"]
    if t is None or not t.host_count("sweep.execute"):
        return None
    return t.host_seconds("sweep.execute") / units * 1e3
