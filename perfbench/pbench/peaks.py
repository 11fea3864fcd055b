"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense, at its
700 W limit): FP32 outside the tensor cores, which the port's float32
kernels and matrix products (TF32 off) can reach, and HBM3 bandwidth. A
share of a peak is stated against these, with the card's power limit
printed beside it."""

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES)
