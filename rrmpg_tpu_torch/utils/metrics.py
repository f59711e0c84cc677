"""Evaluation metrics.

Two API levels, as in ``rrmpg_tpu.utils.metrics``:

* ``nse``, ``mse``, ``rmse``, ``kge``, ``alpha_nse``, ``beta_nse``,
  ``pearson_r`` -- batched torch reductions over one dimension (``dim``),
  on whatever device the inputs live.
* ``calc_*`` -- numpy-facing wrappers with the validation and error
  semantics of the reference (``rrmpg/utils/metrics.py:29-300``), e.g. a
  RuntimeError when the NSE or KGE is undefined.

Missing observations: a NaN in ``obs`` marks a gap and is excluded from
every reduction, in both the ``obs`` and the ``sim`` terms.  Unlike the
JAX XLA metrics, a gap step is dropped even where ``sim`` is NaN there
(the JAX forms multiply ``0 * NaN`` and return NaN): this is what the
fused kernels do, so both engines of the port agree.  A NaN ``sim`` at a
valid step still propagates.
"""

import numpy as np
import torch

from .array_checks import validate_array_input

__all__ = [
    "nse", "mse", "rmse", "kge", "alpha_nse", "beta_nse", "pearson_r",
    "calc_nse", "calc_mse", "calc_rmse", "calc_kge", "calc_alpha_nse",
    "calc_beta_nse", "calc_r", "calibration_loss",
]


def calibration_loss(loss_metric):
    """Minimization-oriented loss ``loss(obs, sim) -> (...)`` for ``fit``.

    'mse' and 'rmse' minimize as they are; 'nse' and 'kge' (ideal value
    1) minimize ``1 - score``.
    """
    if loss_metric == "mse":
        return mse
    if loss_metric == "rmse":
        return rmse
    if loss_metric == "nse":
        return lambda obs, sim, dim=-1: 1.0 - nse(obs, sim, dim)
    if loss_metric == "kge":
        return lambda obs, sim, dim=-1: 1.0 - kge(obs, sim, dim)
    raise ValueError(
        f"Unsupported loss_metric {loss_metric!r}; supported: 'mse', "
        "'rmse', 'nse', 'kge'.")


# ---------------------------------------------------------------------------
# Batched core reductions
# ---------------------------------------------------------------------------

def _sum(x, dim):
    """``x.sum(dim)`` as a pairwise tree of elementwise additions, so that
    each slice is summed in one order whatever the batch around it.  ATen's
    reductions choose their order from the batch's shape and a slice's
    alignment on the card, so a member's loss would change its last bits
    with the number of members beside it and with its row: a mesh shard
    would not reproduce the unsharded run."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    while x.shape[-1] > 1:
        x = torch.nn.functional.pad(x, (0, x.shape[-1] % 2))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _masked(obs, sim, dim):
    """(weights, obs and sim with gap steps zeroed, valid count)."""
    obs, sim = torch.broadcast_tensors(torch.as_tensor(obs),
                                       torch.as_tensor(sim))
    valid = torch.isfinite(obs)
    w = valid.to(obs.dtype)
    zero = torch.zeros((), dtype=obs.dtype, device=obs.device)
    return (w, torch.where(valid, obs, zero), torch.where(valid, sim, zero),
            _sum(w, dim))


def _wmean(w, x, n, dim):
    return _sum(w * x, dim) / n


def _wstd(w, x, n, dim):
    """Population std over the valid steps."""
    mean = _wmean(w, x, n, dim).unsqueeze(dim)
    return torch.sqrt(_sum(w * (x - mean) ** 2, dim) / n)


def mse(obs, sim, dim=-1):
    """Mean squared error along ``dim`` over the valid steps."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    return _sum(w * (obs0 - sim0) ** 2, dim) / n


def rmse(obs, sim, dim=-1):
    """Root mean squared error along ``dim``."""
    return torch.sqrt(mse(obs, sim, dim))


def nse(obs, sim, dim=-1):
    """Nash-Sutcliffe efficiency along ``dim``; ``-inf`` where the
    observation variance is zero (``calc_nse`` raises instead)."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    obs_mean = _wmean(w, obs0, n, dim).unsqueeze(dim)
    denominator = _sum(w * (obs0 - obs_mean) ** 2, dim)
    numerator = _sum(w * (sim0 - obs0) ** 2, dim)
    zero_var = denominator == 0
    score = 1.0 - numerator / torch.where(zero_var, 1.0, denominator)
    return torch.where(zero_var, -torch.inf, score)


def pearson_r(obs, sim, dim=-1):
    """Pearson correlation along ``dim`` over the concurrent valid steps."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    obs_c = obs0 - _wmean(w, obs0, n, dim).unsqueeze(dim)
    sim_c = sim0 - _wmean(w, sim0, n, dim).unsqueeze(dim)
    cov = _sum(w * obs_c * sim_c, dim)
    denom = torch.sqrt(_sum(w * obs_c ** 2, dim) * _sum(w * sim_c ** 2, dim))
    return cov / denom


def alpha_nse(obs, sim, dim=-1):
    """Alpha-NSE decomposition, sigma_sim / sigma_obs."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    return _wstd(w, sim0, n, dim) / _wstd(w, obs0, n, dim)


def beta_nse(obs, sim, dim=-1):
    """Beta-NSE decomposition, (mu_sim - mu_obs) / sigma_obs."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    return ((_wmean(w, sim0, n, dim) - _wmean(w, obs0, n, dim))
            / _wstd(w, obs0, n, dim))


def kge(obs, sim, dim=-1):
    """Kling-Gupta efficiency (Gupta et al. 2009) along ``dim``, with the
    reference's decomposition (``rrmpg/utils/metrics.py:182-188``)."""
    w, obs0, sim0, n = _masked(obs, sim, dim)
    r = pearson_r(obs, sim, dim)
    alpha = _wstd(w, sim0, n, dim) / _wstd(w, obs0, n, dim)
    beta = _wmean(w, sim0, n, dim) / _wmean(w, obs0, n, dim)
    return 1.0 - torch.sqrt((r - 1.0) ** 2 + (alpha - 1.0) ** 2 +
                            (beta - 1.0) ** 2)


# ---------------------------------------------------------------------------
# Validated numpy-facing wrappers (reference error semantics)
# ---------------------------------------------------------------------------

def _validated_pair(obs, sim):
    obs = validate_array_input(obs, np.float64, 'obs')
    sim = validate_array_input(sim, np.float64, 'sim')
    if len(obs) != len(sim):
        raise ValueError(
            f"obs and sim lengths differ: {len(obs)} vs {len(sim)}.")
    valid = np.isfinite(obs)
    if not valid.all():
        if not valid.any():
            raise RuntimeError(
                "Every observation is missing (NaN); no valid timesteps "
                "to score.")
        obs, sim = obs[valid], sim[valid]
    return obs, sim


def calc_nse(obs, sim):
    """Nash-Sutcliffe efficiency; RuntimeError for a constant ``obs``."""
    obs, sim = _validated_pair(obs, sim)
    denominator = np.sum((obs - np.mean(obs)) ** 2)
    if denominator == 0:
        raise RuntimeError(
            "NSE is undefined when the observed series is constant (its "
            "variance is zero); consider MSE for such series.")
    return float(1 - np.sum((sim - obs) ** 2) / denominator)


def calc_rmse(obs, sim):
    """Root mean squared error."""
    obs, sim = _validated_pair(obs, sim)
    return float(np.sqrt(np.mean((obs - sim) ** 2)))


def calc_mse(obs, sim):
    """Mean squared error."""
    obs, sim = _validated_pair(obs, sim)
    return float(np.mean((obs - sim) ** 2))


def calc_kge(obs, sim):
    """Kling-Gupta efficiency; RuntimeError for a zero observation mean
    or standard deviation."""
    obs, sim = _validated_pair(obs, sim)
    mean_obs = np.mean(obs)
    if mean_obs == 0:
        raise RuntimeError(
            "KGE requires a nonzero observation mean (beta term divides "
            "by it).")
    std_obs = np.std(obs)
    if std_obs == 0:
        raise RuntimeError(
            "KGE requires a nonzero observation standard deviation (alpha "
            "term divides by it).")
    r = np.corrcoef(obs, sim)[0, 1]
    alpha = np.std(sim) / std_obs
    beta = np.mean(sim) / mean_obs
    return float(1 - np.sqrt((r - 1) ** 2 + (alpha - 1) ** 2 +
                             (beta - 1) ** 2))


def calc_alpha_nse(obs, sim):
    """Alpha decomposition of the NSE (sigma_sim / sigma_obs)."""
    obs, sim = _validated_pair(obs, sim)
    std_obs = np.std(obs)
    if std_obs == 0:
        raise RuntimeError(
            "Undefined for observations with zero standard deviation.")
    return float(np.std(sim) / std_obs)


def calc_beta_nse(obs, sim):
    """Beta decomposition of the NSE ((mu_sim - mu_obs) / sigma_obs)."""
    obs, sim = _validated_pair(obs, sim)
    std_obs = np.std(obs)
    if std_obs == 0:
        raise RuntimeError(
            "Undefined for observations with zero standard deviation.")
    mean_obs = np.mean(obs)
    if mean_obs == 0:
        raise RuntimeError(
            "Undefined for observations with zero mean.")
    return float((np.mean(sim) - mean_obs) / std_obs)


def calc_r(obs, sim):
    """Pearson r and its two-sided p-value, as ``scipy.stats.pearsonr``."""
    obs, sim = _validated_pair(obs, sim)
    from scipy.stats import pearsonr
    return pearsonr(obs, sim)
