"""The share of the device's busy time spent in matrix-product kernels
(cuBLAS's GEMM, GEMV and nvjet kernels and CUTLASS's, by the symbols
below) over the traced window.
Moves ``train_tokens_per_s``."""

READS = ("device kernels whose names hold one of GEMM_SYMBOLS",)

GEMM_SYMBOLS = ("gemm", "Gemm", "GEMM", "gemv", "Gemv", "cutlass", "xmma",
                "nvjet", "cublas")


def _match(name):
    return any(s in name for s in GEMM_SYMBOLS)


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_s <= 0:
        return None
    return t.op_seconds(_match) / t.busy_s * 100
