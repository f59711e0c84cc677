"""Frozen operation and byte counts of the work the cells ask for, and the
card's published peaks.

Each arithmetic operation, compare-and-select and tanh / sqrt / rsqrt /
pow call counts as one, after the model's equations, so the count says
what these inputs need whatever kernel computes them.  Bytes count each
input read once and each output written once.
"""

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, and the
# device memory rate.  Both assume the card's full 700 W.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops, n_bytes):
    """The least time one card could take for ``ops`` operations moving
    ``n_bytes`` bytes."""
    return max(ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S)
