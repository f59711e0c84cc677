"""Monte-Carlo ensemble simulation.

Counterpart of ``rrmpg_tpu/tools/monte_carlo.py`` (reference contract
``rrmpg/tools/monte_carlo.py:19-76``): ``num`` parameter sets drawn with
the host numpy generator, the whole ensemble simulated as one batched
call, per-member metrics as batched reductions.

With ``return_qsim=False`` and ``engine='fused'`` on a model that has a
fused sufficient-statistics kernel, and every metric derivable from the
four statistics, the evaluation runs through it: one kernel launch, four
numbers per member, no trajectories anywhere.  The FDC signatures 'fhv',
'flv' and 'fms' sort each trajectory, so with any of them the ensemble
goes through ``model.simulate`` (on ``'fused'`` the trajectory kernel).

Results are host numpy arrays, as in the reference.
"""

import numpy as np
import torch

from ..models.basemodel import BaseModel, _no_mesh
from ..ops.stats import losses_from_stats
from ..utils import metrics as _metrics
from ..utils import signatures as _signatures
from ..utils.array_checks import validate_array_input

_METRIC_FNS = {'mse': _metrics.mse, 'rmse': _metrics.rmse,
               'nse': _metrics.nse, 'kge': _metrics.kge,
               'alpha_nse': _metrics.alpha_nse,
               'beta_nse': _metrics.beta_nse, 'r': _metrics.pearson_r,
               # FDC signature diagnostics, the same (obs, sim, dim)
               # contract (see rrmpg_tpu_torch.utils.signatures).
               'fhv': _signatures.fdc_fhv, 'flv': _signatures.fdc_flv,
               'fms': _signatures.fdc_fms}

# Metrics derivable from the fused kernels' (4,) time-mean sufficient
# statistics; key -> name in losses_from_stats.
_STATS_METRICS = {'mse': 'mse', 'rmse': 'rmse', 'nse': 'nse',
                  'kge': 'kge', 'alpha_nse': 'alpha',
                  'beta_nse': 'beta', 'r': 'r'}


def monte_carlo(model, num, qobs=None, mesh=None, metrics=('mse',),
                batch_size=None, return_qsim=True, **kwargs):
    """Perform a Monte-Carlo simulation with ``num`` random parameter sets.

    Args:
        model: an instance of a model of this package.
        num: number of simulations.
        qobs: (optional) observed streamflow; if given, the requested
            ``metrics`` of each simulation are returned.
        mesh: not ported yet; must be None (``rrmpg_tpu`` shards the
            ensemble over it); anything else raises
            ``NotImplementedError`` before any sampling.
        metrics: any of 'mse', 'rmse', 'nse', 'kge', 'alpha_nse',
            'beta_nse', 'r' (default ('mse',), the reference's contract),
            plus the FDC signature diagnostics 'fhv', 'flv', 'fms'
            (:mod:`rrmpg_tpu_torch.utils.signatures`).
        batch_size: (optional) evaluate the ensemble in member chunks of
            this size to bound device memory.
        return_qsim: with ``False`` (requires ``qobs``) trajectories are not
            kept; with ``engine='fused'`` on a model with a fused statistics
            kernel and every metric in {'mse', 'rmse', 'nse', 'kge',
            'alpha_nse', 'beta_nse', 'r'} they are never computed either.
        **kwargs: inputs passed through to ``model.simulate``.

    Returns:
        dict with ``'params'`` (structured array of the sampled sets),
        ``'qsim'`` ((T, num), omitted with ``return_qsim=False``) and one
        (num,) array per requested metric if ``qobs`` was given.

    Raises:
        ValueError: If any input contains invalid values.
        TypeError: If any input has a wrong datatype.
    """
    _no_mesh(mesh)
    if not isinstance(model, BaseModel):
        raise TypeError(
            f"monte_carlo needs an rrmpg_tpu_torch model instance (a "
            f"BaseModel subclass); got {type(model).__name__}.")
    if not isinstance(num, int) or num < 1:
        raise TypeError(
            f"The ensemble size 'num' must be an integer >= 1; got {num!r}.")
    if batch_size is not None and (not isinstance(batch_size, int)
                                   or batch_size < 1):
        raise TypeError(
            f"'batch_size' must be an integer >= 1 or None; got "
            f"{batch_size!r}.")
    unknown = [m for m in metrics if m not in _METRIC_FNS]
    if unknown:
        raise ValueError("Unknown metric(s) {}; choose from {}".format(
            unknown, sorted(_METRIC_FNS)))
    if qobs is not None:
        qobs = validate_array_input(qobs, np.float64, 'qobs')
    if not return_qsim and qobs is None:
        raise ValueError(
            "return_qsim=False discards the trajectories, so 'qobs' and "
            "'metrics' are the only output; pass qobs (or keep "
            "return_qsim=True).")

    params = model.get_random_params(num=num)

    stats_fn = getattr(model, "_fused_stats", None)
    use_stats = (not return_qsim and stats_fn is not None
                 and kwargs.get("engine") == "fused"
                 and all(m in _STATS_METRICS for m in metrics))
    if use_stats:
        def evaluate(param_chunk):
            pd, _ = model._prepare_params(param_chunk)
            stats = stats_fn(qobs, pd, kwargs)
            losses = losses_from_stats(stats, qobs)
            out = {}
            for m in metrics:
                if m == 'beta_nse':
                    # NSE decomposition (mu_sim - mu_obs) / sigma_obs, not
                    # the KGE beta ratio of losses_from_stats.
                    out[m] = ((stats[1].cpu().numpy() - qobs.mean())
                              / qobs.std())
                else:
                    out[m] = losses[_STATS_METRICS[m]].cpu().numpy()
            return None, out
    else:
        def evaluate(param_chunk):
            qsim = model.simulate(params=param_chunk, **kwargs)
            per_metric = {}
            if qobs is not None:
                obs = torch.as_tensor(qobs, dtype=qsim.dtype,
                                      device=qsim.device)
                for name in metrics:
                    per_metric[name] = _METRIC_FNS[name](
                        obs[:, None], qsim, dim=0).cpu().numpy()
            return (qsim.cpu().numpy() if return_qsim else None), per_metric

    if batch_size is None or batch_size >= num:
        qsim, per_metric = evaluate(params)
    else:
        qsim_parts, metric_parts = [], {m: [] for m in metrics}
        for lo in range(0, num, batch_size):
            q, pm = evaluate(params[lo:lo + batch_size])
            if q is not None:
                qsim_parts.append(q)
            for name, vals in pm.items():
                metric_parts[name].append(vals)
        qsim = (np.concatenate(qsim_parts, axis=-1)
                if qsim_parts else None)
        per_metric = {name: np.concatenate(parts)
                      for name, parts in metric_parts.items()}

    result = {'params': params}
    if qsim is not None:
        result['qsim'] = qsim
    if qobs is not None:
        result.update(per_metric)
    return result
