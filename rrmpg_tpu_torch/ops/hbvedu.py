"""HBV educational model (Aghakouchak & Habib 2010), plain batched PyTorch
(the ``'scan'`` engine).

Counterpart of ``rrmpg_tpu/ops/hbvedu.py`` with the member axis written
out instead of ``vmap``: a sequential loop over four storages (snow, soil,
near-surface s1, base-flow s2) with degree-day snow accounting and a
reservoir cascade (reference ``rrmpg/models/hbvedu_model.py:15-129``).

The monthly climatology lookups ``pe_m[month[t]]`` / ``t_m[month[t]]`` are
one gather before the loop; the loop body is elementwise arithmetic on
(N,) tensors.  The soil store is not clamped: a negative level gives NaN
through the ``Beta`` power, as the reference's ``np.power`` does.

Shapes: forcing (T,), ``month`` (T,) 0-based integers, climatologies
(12,), parameters (N,), series (N, T).
"""

import torch

from ._ties import clamp_min0

PARAM_NAMES = ('T_t', 'DD', 'FC', 'Beta', 'C', 'PWP', 'K_0', 'K_1', 'K_2',
               'K_p', 'L')


def hbv_step(state, temp_t, prec_t, pe_month_t, t_month_t, params):
    """One HBV-Edu step on (N,) tensors; returns (new_state, qsim_t) with
    ``state = (snow, soil, s1, s2)``."""
    snow_prev, soil_prev, s1_prev, s2_prev = state
    T_t, DD, FC, Beta, C, PWP, K_0, K_1, K_2, K_p, L = (
        params[k] for k in PARAM_NAMES)

    freezing = temp_t < T_t
    melt_pot = DD * (temp_t - T_t)
    snow = torch.where(freezing, snow_prev + prec_t,
                       clamp_min0(snow_prev - melt_pot))
    liquid_water = torch.where(
        freezing, 0.0, prec_t + torch.minimum(snow_prev, melt_pot))

    prec_eff = liquid_water * (soil_prev / FC) ** Beta

    pe = (1.0 + C * (temp_t - t_month_t)) * pe_month_t
    ea = torch.where(soil_prev > PWP, pe, pe * (soil_prev / PWP))

    soil = soil_prev + liquid_water - prec_eff - ea

    overflow = clamp_min0(s1_prev - L) * K_0
    s1 = s1_prev + prec_eff - overflow - s1_prev * K_1 - s1_prev * K_p
    s2 = s2_prev + s1_prev * K_p - s2_prev * K_2

    qsim = overflow + s1 * K_1 + s2 * K_2
    return (snow, soil, s1, s2), qsim


def _scan(temp, prec, pe_month, t_month, state, params, first):
    """Steps ``first .. T-1`` from ``state``; writes five (N, T) series and
    returns them with the final state.  Index 0 is left to the caller when
    ``first == 1``."""
    n, T = params['T_t'].shape[0], prec.shape[0]
    series = [prec.new_empty((n, T)) for _ in range(5)]
    for t in range(first, T):
        state, q = hbv_step(state, temp[t], prec[t], pe_month[t], t_month[t],
                            params)
        for out, value in zip(series, (q, *state)):
            out[:, t] = value
    return series, state


def _initial(prec, n, values):
    return tuple(torch.as_tensor(v, dtype=prec.dtype,
                                 device=prec.device).expand(n).clone()
                 for v in values)


def run_hbvedu(temp, prec, month, pe_m, t_m, snow_init, soil_init, s1_init,
               s2_init, params, return_final=False):
    """Simulate the HBV-Edu model for a batch of parameter sets.

    Args:
        temp, prec: (T,) daily mean temperature and precipitation.
        month: (T,) integer month index of each timestep, 0-based.
        pe_m, t_m: (12,) long-term monthly potential evapotranspiration and
            mean temperature.
        snow_init, soil_init, s1_init, s2_init: initial storages, scalars
            or (N,) tensors.
        params: dict of (N,) tensors T_t, DD, FC, Beta, C, PWP, K_0, K_1,
            K_2, K_p, L.
        return_final: also return the final ``(snow, soil, s1, s2)``,
            suitable for :func:`run_hbvedu_warm`.

    Returns:
        (qsim, snow, soil, s1, s2), each (N, T); index 0 holds the initial
        storages and ``qsim[:, 0] = 0`` (the reference loop starts at t=1).
        With ``return_final`` additionally the final storage tuple.
    """
    n = params['T_t'].shape[0]
    init = _initial(prec, n, (snow_init, soil_init, s1_init, s2_init))
    series, final = _scan(temp, prec, pe_m[month], t_m[month], init, params,
                          first=1)
    for out, value in zip(series, (0.0, *init)):
        out[:, 0] = value
    if return_final:
        return (*series, final)
    return tuple(series)


def run_hbvedu_warm(temp, prec, month, pe_m, t_m, state, params):
    """Continue an HBV-Edu simulation from carried storages.

    Unlike :func:`run_hbvedu`, every timestep advances the model from
    ``state``, so chaining segments through the returned final state
    reproduces the unbroken trajectory.

    Args:
        temp, prec, month, pe_m, t_m, params: as :func:`run_hbvedu`.
        state: tuple ``(snow, soil, s1, s2)`` of carried storages.

    Returns:
        (qsim, snow, soil, s1, s2, final_state).
    """
    n = params['T_t'].shape[0]
    series, final = _scan(temp, prec, pe_m[month], t_m[month],
                          _initial(prec, n, state), params, first=0)
    return (*series, final)
