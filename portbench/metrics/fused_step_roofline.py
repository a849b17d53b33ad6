"""The fused resident step's share of its roofline: the bytes of the
function prox(W (x - alpha v)) over every cell of the grid (``frozen
.counts.fused_step_bytes``: inputs read once, the output written once) at
the card's HBM rate, over the device time of the kernels that computed
it in the traced window.  Moves ``logreg_epochs_per_s``."""

from pbcore.frozen.peaks import HBM_BYTES_PER_S

READS = ("device kernels named fused_step_kernel",)


def _match(name):
    return "fused_step_kernel" in name


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    n = t.op_count(_match)
    secs = t.op_seconds(_match)
    if n == 0 or secs <= 0:
        return None
    return n * ctx["work"]["fused_step_bytes"] / HBM_BYTES_PER_S / secs * 100
