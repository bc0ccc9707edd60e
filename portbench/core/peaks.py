"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time an operation
can take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def bound_seconds(nbytes: float, flops: float = 0.0,
                  flops_per_s: float = F32_FLOPS) -> float:
    """The larger of the bytes over the memory bandwidth and the
    operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
