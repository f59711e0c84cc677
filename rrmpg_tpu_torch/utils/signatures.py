"""Hydrological signature metrics (flow-duration-curve diagnostics).

Counterpart of ``rrmpg_tpu/utils/signatures.py``: the flow-duration-curve
trio of Yilmaz, Gupta & Wagener (2008) plus two hydrograph-shape
measures, as torch reductions over one dimension (``dim``, where the JAX
package takes ``axis``), batched over ensembles like
:mod:`rrmpg_tpu_torch.utils.metrics`:

* :func:`fdc_fhv` -- peak-flow (high-segment volume) percent bias;
* :func:`fdc_flv` -- low-flow (log-space low-segment volume) percent bias;
* :func:`fdc_fms` -- mid-segment slope percent bias;
* :func:`flashiness` -- Richards-Baker flashiness index of one series;
* :func:`runoff_ratio` -- long-term discharge over precipitation.

Positive FHV / FLV / FMS: the simulation over-predicts that segment.  The
functions sort internally, so inputs are plain hydrographs; the reduced
dimension is time and any other broadcasts, so ``(T, 1)`` obs against
``(T, N)`` sim with ``dim=0`` evaluates a whole ensemble in one call.
``torch.sort`` puts NaN last, as ``jnp.sort`` does, so a NaN trajectory
gives NaN, as in the JAX package.
"""

import torch

__all__ = ["fdc_fhv", "fdc_flv", "fdc_fms", "flashiness", "runoff_ratio"]

_EPS = 1e-6


def _descending(x, dim):
    return -torch.sort(-x, dim=dim).values


def _exceedance_count(x, dim, fraction):
    """Static number of timesteps in the top ``fraction`` of the FDC."""
    return max(1, int(round(fraction * x.shape[dim])))


def fdc_fhv(obs, sim, h=0.02, dim=-1):
    """High-segment volume percent bias of the flow-duration curve.

    ``FHV = 100 * (sum(sim_top) - sum(obs_top)) / sum(obs_top)`` over the
    flows with exceedance probability <= ``h`` (default top 2 %), each
    series sorted separately (Yilmaz et al. 2008, eq. A3).
    """
    obs, sim = torch.as_tensor(obs), torch.as_tensor(sim)
    k = _exceedance_count(obs, dim, h)
    obs_top = _descending(obs, dim).narrow(dim, 0, k).sum(dim)
    sim_top = _descending(sim, dim).narrow(dim, 0, k).sum(dim)
    return 100.0 * (sim_top - obs_top) / (obs_top + _EPS)


def fdc_flv(obs, sim, l=0.3, dim=-1):
    """Low-segment (log-space) volume percent bias of the FDC.

    Each series' bottom ``l`` fraction in log space, referenced to its own
    minimum (Yilmaz et al. 2008, eq. A4; flows clipped at 1e-6 for dry
    series): ``FLV = 100 * (sum(log sim_low - log sim_min) - sum(log
    obs_low - log obs_min)) / sum(log obs_low - log obs_min)``.
    """
    obs, sim = torch.as_tensor(obs), torch.as_tensor(sim)
    t_len = obs.shape[dim]
    k = _exceedance_count(obs, dim, l)

    def low_volume(x):
        lo = torch.log(torch.clamp_min(
            _descending(x, dim).narrow(dim, t_len - k, k), _EPS))
        return (lo - lo.amin(dim, keepdim=True)).sum(dim)

    v_obs = low_volume(obs)
    return 100.0 * (low_volume(sim) - v_obs) / (v_obs + _EPS)


def fdc_fms(obs, sim, lower=0.2, upper=0.7, dim=-1):
    """Mid-segment slope percent bias of the FDC.

    The log-space FDC slope between the ``lower`` and ``upper`` exceedance
    probabilities (default 20 %-70 %) measures flow variability; percent
    bias of sim vs obs slope (Yilmaz et al. 2008, eq. A2).
    """
    obs, sim = torch.as_tensor(obs), torch.as_tensor(sim)
    i_lo = _exceedance_count(obs, dim, lower) - 1
    i_hi = _exceedance_count(obs, dim, upper) - 1

    def slope(x):
        d = _descending(x, dim)
        return (torch.log(torch.clamp_min(d.select(dim, i_lo), _EPS))
                - torch.log(torch.clamp_min(d.select(dim, i_hi), _EPS)))

    s_obs = slope(obs)
    return 100.0 * (slope(sim) - s_obs) / (s_obs + _EPS)


def flashiness(q, dim=-1):
    """Richards-Baker flashiness index: ``sum|dq| / sum q`` (0 for constant
    flow, larger for flashier catchments; Baker et al. 2004)."""
    q = torch.as_tensor(q)
    return (torch.diff(q, dim=dim).abs().sum(dim)
            / (q.sum(dim) + _EPS))


def runoff_ratio(q, prec, dim=-1):
    """Long-term runoff ratio ``sum(q) / sum(prec)`` (water balance)."""
    q, prec = torch.as_tensor(q), torch.as_tensor(prec)
    return q.sum(dim) / (prec.sum(dim) + _EPS)
