"""Host time a grid spends planning and staging: the program's
``sweep.plan`` and ``sweep.stage`` spans (``core/sweep.py``) in the traced
window, per grid.  Moves ``logreg_epochs_per_s``."""

READS = ("program span sweep.plan", "program span sweep.stage")


def read(ctx):
    t, units = ctx["trace"], ctx["work"]["units"]
    if t is None or not t.host_count("sweep.plan"):
        return None
    return (t.host_seconds("sweep.plan") + t.host_seconds("sweep.stage")) \
        / units * 1e3
