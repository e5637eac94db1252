"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in float32
outside the tensor cores (every configuration's state is float32)."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time of a piece of work: the larger of its bytes over the
    memory bandwidth and its operations over the arithmetic peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)
