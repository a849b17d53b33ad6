"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W).

Float32 products are held against the TF32 tensor-core rate: it is the
highest rate the card has for float32 operands, so a float32-accurate
split over the tensor cores (3xTF32) still reads below 100%.  The 67
TFLOP/s of the CUDA cores' FFMA path would read above it."""

F32_PRODUCT_FLOPS = 495e12      # TF32 tensor cores
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float,
                  peak: float = F32_PRODUCT_FLOPS) -> float:
    """The least time a unit of work needs: bounded by operations or by
    bytes, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
