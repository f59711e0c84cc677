"""Nash-Sutcliffe efficiency and Kling-Gupta efficiency from time means.

NSE (Nash & Sutcliffe 1970) and KGE (Gupta et al. 2009) of members whose
time means [mse, mean q, mean q^2, mean q qobs] over the observed days are
given, against observations whose moments are taken here from the raw
series.  Plain PyTorch; imports nothing of the program under test.
"""

import torch


def scores(stats, qobs):
    """{'nse': (M,), 'kge': (M,)} from (4, M) ``stats`` and (T,) or (T, M)
    ``qobs`` (NaN marks a day without an observation)."""
    valid = torch.isfinite(qobs)
    obs = torch.where(valid, qobs, torch.zeros_like(qobs))
    count = valid.sum(dim=0).to(stats.dtype)
    mean_obs = obs.sum(dim=0) / count
    var_obs = (obs * obs).sum(dim=0) / count - mean_obs * mean_obs
    mse, mean_q, mean_q2, mean_qo = stats
    std_q = torch.sqrt(torch.clamp(mean_q2 - mean_q * mean_q, min=0.0))
    std_obs = torch.sqrt(var_obs)
    r = (mean_qo - mean_q * mean_obs) / (std_q * std_obs)
    alpha = std_q / std_obs
    beta = mean_q / mean_obs
    kge = 1.0 - torch.sqrt((r - 1.0) ** 2 + (alpha - 1.0) ** 2
                           + (beta - 1.0) ** 2)
    return {"nse": 1.0 - mse / var_obs, "kge": kge}


def widest_gap(got, want):
    """The widest gap between the program's values ``got`` and the
    reference's ``want``, each relative to max(1, |want|): a score near 1
    is held absolutely, a large loss relatively.  A value that is finite on
    one side only reads inf; NaN on both sides agrees."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    both_nan = torch.isnan(got) & torch.isnan(want)
    gap = (got - want).abs() / torch.clamp(want.abs(), min=1.0)
    gap = torch.where(both_nan, torch.zeros_like(gap), gap)
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, torch.inf), gap)
    return float(gap.max()) if gap.numel() else float("inf")
