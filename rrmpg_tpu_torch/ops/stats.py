"""Objectives from the fused kernels' sufficient statistics.

Counterpart of ``rrmpg_tpu/ops/pallas_snow.py:674-710``
(``losses_from_stats``), moved into a module of its own because every
model family's stats kernel feeds it.
"""

import torch

from ..utils.tracing import traced


@traced("ops.losses_from_stats")
def losses_from_stats(stats, qobs):
    """Objective values from time-mean sufficient statistics.

    Args:
        stats: (4, N) tensor [mse, mean_q, mean_q^2, mean_q*qobs], as
            returned by the fused objective wrappers with ``stats=True``.
        qobs: (T,) observations; NaN marks a gap and is excluded from the
            observation moments, as the masked kernels exclude it from
            the member statistics.

    Returns:
        dict of (N,) tensors: 'mse', 'rmse', 'nse', 'kge', 'alpha',
        'beta', 'r' (KGE decomposition of ``rrmpg/utils/metrics.py:182-188``).
    """
    qobs = torch.as_tensor(qobs, dtype=stats.dtype, device=stats.device)
    valid = torch.isfinite(qobs)
    w = valid.to(stats.dtype)
    qobs0 = torch.where(valid, qobs, 0.0)
    n = w.sum()
    mean_obs = (w * qobs0).sum() / n
    var_obs = (w * qobs0 * qobs0).sum() / n - mean_obs * mean_obs
    std_obs = torch.sqrt(torch.clamp(var_obs, min=0.0))

    mse_v, mean_q, mean_q2, mean_qo = stats
    std_q = torch.sqrt(torch.clamp(mean_q2 - mean_q * mean_q, min=0.0))
    cov = mean_qo - mean_q * mean_obs
    r = cov / (std_q * std_obs)
    alpha = std_q / std_obs
    beta = mean_q / mean_obs
    kge = 1.0 - torch.sqrt((r - 1.0) ** 2 + (alpha - 1.0) ** 2 +
                           (beta - 1.0) ** 2)
    nse = 1.0 - mse_v / var_obs
    return {'mse': mse_v, 'rmse': torch.sqrt(mse_v), 'nse': nse, 'kge': kge,
            'alpha': alpha, 'beta': beta, 'r': r}
