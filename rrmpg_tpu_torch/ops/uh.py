"""GR4J unit-hydrograph ordinates over fixed register lengths.

Counterpart of ``rrmpg_tpu/ops/uh.py``.  The reference sizes its UH
buffers per run as ``ceil(x4)`` / ``ceil(2*x4+1)``
(``rrmpg/models/gr4j_model.py:67-69``); here they have fixed lengths
covering the widest published bound (x4 <= 10).  The S-curves saturate
at 1 beyond x4 (resp. 2*x4), so every ordinate past the reference's
length is exactly zero and the padded filters reproduce the dynamic
result.

Everything is batched over a leading member axis: ``x4`` of shape (N,)
gives ordinates of shape (N, num_uh).
"""

import numpy as np
import torch

from ._ties import clamp01

MAX_X4 = 10.0
NUM_UH1 = int(MAX_X4)            # ceil(x4)       <= 10
NUM_UH2 = int(2 * MAX_X4 + 1)    # ceil(2*x4 + 1) <= 21


def required_uh_lengths(x4_values):
    """Static UH register lengths covering every x4 in ``x4_values``,
    never below (NUM_UH1, NUM_UH2)."""
    if isinstance(x4_values, torch.Tensor):
        x4_max = float(x4_values.max())
    else:
        x4_max = float(np.max(np.asarray(x4_values)))
    n1 = max(int(np.ceil(x4_max)), 1)
    n2 = max(int(np.ceil(2.0 * x4_max + 1.0)), 1)
    return max(n1, NUM_UH1), max(n2, NUM_UH2)


def s_curve1(t, x4):
    """SH1 S-curve (reference ``gr4j_model.py:159-173``), for t >= 0."""
    frac = clamp01(t / x4)
    return torch.where(t <= 0, 0.0, frac ** 2.5)


def s_curve2(t, x4):
    """SH2 S-curve (reference ``gr4j_model.py:176-192``)."""
    ratio = t / x4
    rising = 0.5 * clamp01(ratio) ** 2.5
    falling = 1.0 - 0.5 * clamp01(2.0 - ratio) ** 2.5
    out = torch.where(t <= x4, rising, falling)
    return torch.where(t <= 0, 0.0, out)


def uh_ordinates(x4, num_uh1=NUM_UH1, num_uh2=NUM_UH2):
    """UH1/UH2 ordinates for a batch of x4 values.

    Args:
        x4: tensor of shape (...,).

    Returns:
        (oh1, oh2) of shapes (..., num_uh1) and (..., num_uh2); entries
        beyond ceil(x4) / ceil(2*x4+1) are exactly zero.
    """
    x4 = x4.unsqueeze(-1)
    j1 = torch.arange(1, num_uh1 + 1, dtype=x4.dtype, device=x4.device)
    j2 = torch.arange(1, num_uh2 + 1, dtype=x4.dtype, device=x4.device)
    oh1 = s_curve1(j1, x4) - s_curve1(j1 - 1.0, x4)
    oh2 = s_curve2(j2, x4) - s_curve2(j2 - 1.0, x4)
    return oh1, oh2


def causal_fir(x, taps):
    """Causal FIR filter along the last axis: ``y[t] = sum_j taps[j] x[t-j]``.

    ``x`` is (..., T) and ``taps`` is (..., K) with matching leading
    axes (per-member taps).  Written as a sum of K shifted slices: a
    ``conv1d`` would need ``groups=N`` for per-member taps and, in
    float32 on the GPU, goes through cuDNN in TF32 (about three decimal
    digits).
    """
    T = x.shape[-1]
    y = taps[..., :1] * x
    for j in range(1, min(taps.shape[-1], T)):
        y[..., j:] += taps[..., j:j + 1] * x[..., :T - j]
    return y
