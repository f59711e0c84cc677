"""Cemaneige snow accounting (Valery 2010), with the SWE-SCA linear
hysteresis (Riboust et al. 2019) and a degree-day ice-melt routine (Nepal
et al. 2017), plain batched PyTorch (the ``'scan'`` engine).

Counterpart of ``rrmpg_tpu/ops/cemaneige.py`` with the member axis written
out instead of ``vmap`` (reference loops:
``rrmpg/models/cemaneige_model.py:15-127``,
``rrmpg/models/cemaneigehyst_model.py:4-166``,
``rrmpg/models/icemelt_model.py:15-65``).  The elevation layers are a
vector axis of the state: each step of the time loop updates all members
and layers as one (N, L) block.  The series constant (the snow-cover
threshold from the mean annual solid precipitation,
``cemaneige_model.py:80``) is one reduction before the loop.

Timestep 0 initializes the stores instead of updating them
(``cemaneige_model.py:85-96``); the warm functions never do.

Shapes: layer forcing (T, L), parameters (N,), states (N, L), series
(N, T) and (N, T, L).
"""

import torch

MELT_TEMP = 0.0
MIN_MELT_SHARE = 0.1
SNOW_SHIELD_THRESHOLD = 1.0  # mm SWE above which snow shields ice from melt


def _split_precipitation(prec, frac_solid_prec):
    snow = prec * frac_solid_prec
    rain = prec - snow
    return snow, rain


def _column(params, key):
    """Parameter ``key`` as an (N, 1) column against the layer axis."""
    return params[key][:, None]


def _level(value, like):
    """A scalar initial level as an (N, L) block like ``like``."""
    return torch.full_like(like, float(value))


def _thermal_and_potential_melt(eTG, temp_t, G, CTG, Kf):
    """Snowpack thermal state and potential melt of one step."""
    eTG = torch.clamp(eTG, max=0.0)
    melting = (eTG == 0.0) & (temp_t > MELT_TEMP)
    pot_melt = torch.where(melting, torch.minimum(Kf * temp_t, G), 0.0)
    return eTG, pot_melt


def _cemaneige_scan(snow, rain, temp, state, g_thresh, params, cold_inits):
    """Plain Cemaneige over the series from ``state = (G, eTG)``; with
    ``cold_inits = (snow_pack_init, thermal_state_init)`` step 0 sets the
    stores to them instead.  Returns (liquid, G, eTG) series, each
    (N, T, L), and the final state."""
    CTG, Kf = _column(params, 'CTG'), _column(params, 'Kf')
    safe_g_thresh = torch.where(g_thresh > 0, g_thresh, 1.0)
    G, eTG = state
    n, (T, L) = G.shape[0], snow.shape
    liquid_s, G_s, eTG_s = (snow.new_empty((n, T, L)) for _ in range(3))
    for t in range(T):
        if t == 0 and cold_inits is not None:
            G, eTG = _level(cold_inits[0], G), _level(cold_inits[1], G)
        else:
            G = G + snow[t]
            eTG = CTG * eTG + (1.0 - CTG) * temp[t]
        eTG, pot_melt = _thermal_and_potential_melt(eTG, temp[t], G, CTG, Kf)
        g_ratio = torch.where(G < g_thresh, G / safe_g_thresh, 1.0)
        melt = (0.9 * g_ratio + MIN_MELT_SHARE) * pot_melt
        G = G - melt
        liquid_s[:, t], G_s[:, t], eTG_s[:, t] = rain[t] + melt, G, eTG
    return (liquid_s, G_s, eTG_s), (G, eTG)


def _cemaneigehyst_scan(snow, rain, temp, state, psol_annual, params,
                        cold_inits):
    """Hysteresis Cemaneige over the series from ``state = (G, eTG, sca,
    swe_max)``; ``cold_inits`` as in :func:`_cemaneige_scan` (SCA and the
    SWE maximum start from 0).  Returns (liquid, G, eTG, sca) series and
    the final state."""
    CTG, Kf = _column(params, 'CTG'), _column(params, 'Kf')
    Thacc = _column(params, 'Thacc')
    th_melt = psol_annual * _column(params, 'Rsp')
    G, eTG, sca, swe_max = state
    n, (T, L) = G.shape[0], snow.shape
    liquid_s, G_s, eTG_s, sca_s = (snow.new_empty((n, T, L))
                                   for _ in range(4))
    for t in range(T):
        if t == 0 and cold_inits is not None:
            G, eTG = _level(cold_inits[0], G), _level(cold_inits[1], G)
            sca, swe_max = torch.zeros_like(G), torch.zeros_like(G)
        else:
            G = G + snow[t]
            eTG = CTG * eTG + (1.0 - CTG) * temp[t]
        eTG, pot_melt = _thermal_and_potential_melt(eTG, temp[t], G, CTG, Kf)

        snow_balance = snow[t] - pot_melt
        accumulating = snow_balance >= 0
        # Accumulation: SCA grows with the SWE increment and the SWE
        # maximum is tracked.  Ablation: SCA follows SWE relative to Thmax.
        sca_acc = sca + snow_balance / Thacc
        th_max = torch.minimum(swe_max, th_melt)
        sca_abl = torch.where(
            th_max > 0, G / torch.where(th_max > 0, th_max, 1.0), 0.0)
        sca = torch.clamp(torch.where(accumulating, sca_acc, sca_abl),
                          0.0, 1.0)
        swe_max = torch.where(accumulating, torch.maximum(swe_max, G),
                              swe_max)

        melt = torch.minimum((0.9 * sca + MIN_MELT_SHARE) * pot_melt, G)
        G = G - melt
        # The SWE maximum is forgotten when the pack empties.
        swe_max = torch.where(G == 0.0, 0.0, swe_max)
        liquid_s[:, t], G_s[:, t] = rain[t] + melt, G
        eTG_s[:, t], sca_s[:, t] = eTG, sca
    return (liquid_s, G_s, eTG_s, sca_s), (G, eTG, sca, swe_max)


def _zeros(params, prec):
    return prec.new_zeros((params['CTG'].shape[0], prec.shape[1]))


def run_cemaneige(prec, mean_temp, frac_solid_prec, snow_pack_init,
                  thermal_state_init, params, return_final=False):
    """Simulate the Cemaneige snow routine for a batch of parameter sets.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing series.
        snow_pack_init, thermal_state_init: scalar initial states (applied
            to every layer at t=0, reference ``cemaneige_model.py:85-96``).
        params: dict of (N,) tensors 'CTG', 'Kf'.
        return_final: also return ``(G, eTG, g_thresh)`` -- the final
            (N, L) layer states plus this series' (L,) snow-cover
            threshold, the inputs :func:`run_cemaneige_warm` needs to
            continue.

    Returns:
        outflow: (N, T) catchment liquid-water outflow (mean over layers).
        G: (N, T, L) snowpack state.
        eTG: (N, T, L) snowpack thermal state.
    """
    snow, rain = _split_precipitation(prec, frac_solid_prec)
    # Snow-cover threshold from mean annual solid precipitation (per layer).
    g_thresh = 0.9 * 365.25 * snow.mean(dim=0)
    zeros = _zeros(params, prec)
    (liquid, G, eTG), final = _cemaneige_scan(
        snow, rain, mean_temp, (zeros, zeros), g_thresh, params,
        (snow_pack_init, thermal_state_init))
    outflow = liquid.mean(dim=2)
    if return_final:
        return outflow, G, eTG, (*final, g_thresh)
    return outflow, G, eTG


def run_cemaneigehyst(prec, mean_temp, frac_solid_prec, snow_pack_init,
                      thermal_state_init, sca_init, params,
                      return_final=False):
    """Cemaneige with SWE-SCA linear hysteresis for a batch of parameter
    sets.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing series.
        snow_pack_init, thermal_state_init, sca_init: scalar initial
            states.  Following the reference trajectory exactly,
            ``sca_init`` does not influence the simulation -- the
            reference assigns it at t=0 but overwrites it with the
            accumulation / ablation branch before any read
            (``cemaneigehyst_model.py:100-143``).
        params: dict of (N,) tensors 'CTG', 'Kf', 'Thacc', 'Rsp'.
        return_final: also return ``(G, eTG, sca, swe_max, psol_annual)``
            -- the final (N, L) layer states plus this series' (L,) mean
            annual solid precipitation, the inputs
            :func:`run_cemaneigehyst_warm` needs to continue.

    Returns:
        outflow: (N, T) catchment outflow (mean over layers).
        G, eTG, sca: (N, T, L) state series; rain: (T, L), the same for
        every member.
    """
    del sca_init  # Kept for API parity; see docstring.
    snow, rain = _split_precipitation(prec, frac_solid_prec)
    psol_annual = 365.25 * snow.mean(dim=0)
    zeros = _zeros(params, prec)
    (liquid, G, eTG, sca), final = _cemaneigehyst_scan(
        snow, rain, mean_temp, (zeros, zeros, zeros, zeros), psol_annual,
        params, (snow_pack_init, thermal_state_init))
    outflow = liquid.mean(dim=2)
    if return_final:
        return outflow, G, eTG, sca, rain, (*final, psol_annual)
    return outflow, G, eTG, sca, rain


def run_cemaneige_warm(prec, mean_temp, frac_solid_prec, state, g_thresh,
                       params):
    """Continue a Cemaneige simulation from carried layer states.

    Every timestep advances the per-layer snowpack from ``state`` (no t=0
    initialization), so chained segments reproduce an unbroken run.  The
    snow-cover threshold is a precompute over the ORIGINAL series
    (``cemaneige_model.py:80``) and must be supplied: pass the ``g_thresh``
    a ``return_final=True`` run returned, not one of this segment.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) continuation forcing.
        state: tuple ``(G, eTG)`` of (N, L) carried layer states.
        g_thresh: (L,) or (N, L) snow-cover thresholds.
        params: dict of (N,) tensors 'CTG', 'Kf'.

    Returns:
        (outflow, G, eTG, final_state) with ``final_state = (G_L, eTG_L)``.
    """
    snow, rain = _split_precipitation(prec, frac_solid_prec)
    (liquid, G, eTG), final = _cemaneige_scan(
        snow, rain, mean_temp, tuple(state), g_thresh, params, None)
    return liquid.mean(dim=2), G, eTG, final


def run_cemaneigehyst_warm(prec, mean_temp, frac_solid_prec, state,
                           psol_annual, params):
    """Continue a hysteresis-Cemaneige simulation from carried states.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) continuation forcing.
        state: tuple ``(G, eTG, sca, swe_max)`` of (N, L) carried states.
        psol_annual: (L,) or (N, L) mean annual solid precipitation of the
            ORIGINAL series (same caveat as :func:`run_cemaneige_warm`).
        params: dict of (N,) tensors 'CTG', 'Kf', 'Thacc', 'Rsp'.

    Returns:
        (outflow, G, eTG, sca, rain, final_state).
    """
    snow, rain = _split_precipitation(prec, frac_solid_prec)
    (liquid, G, eTG, sca), final = _cemaneigehyst_scan(
        snow, rain, mean_temp, tuple(state), psol_annual, params, None)
    return liquid.mean(dim=2), G, eTG, sca, rain, final


def run_icemelt(temp, snow, params):
    """Degree-day glacier ice melt; elementwise (no recurrence).

    Melt is suppressed where the snowpack exceeds 1 mm SWE (snow shields the
    ice), following the reference (``icemelt_model.py:54-63``).

    Args:
        temp: (T, L) mean temperature per layer.
        snow: (N, T, L) snowpack state per layer (G from the snow routine).
        params: dict with the (N,) tensor 'DDF'.

    Returns:
        (N, T, L) ice-melt liquid water.
    """
    melt = torch.clamp(params['DDF'][:, None, None] * (temp - MELT_TEMP),
                       min=0.0)
    return torch.where(snow > SNOW_SHIELD_THRESHOLD, 0.0, melt)
