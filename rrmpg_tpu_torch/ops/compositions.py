"""Coupled models: snow routines chained into GR4J, plain batched PyTorch
(the ``'scan'`` engine).

Counterpart of ``rrmpg_tpu/ops/compositions.py`` (reference couplings
``rrmpg/models/cemaneigegr4j_model.py:16-63``,
``cemaneigehystgr4j_model.py:16-79``, ``cemaneigegr4jice_model.py:19-93``,
``cemaneigehystgr4jice_model.py:21-104``): the snow routine's catchment
outflow becomes the GR4J precipitation input, one series per member
(:func:`~.gr4j.run_gr4j` takes it as (T, N)); the ice variants add a
glacier-fraction-weighted degree-day melt term.

Shapes: layer forcing (T, L), ``etp`` (T,), parameters (N,), series (N, T)
and (N, T, L).
"""

import torch

from .cemaneige import (run_cemaneige, run_cemaneige_warm, run_cemaneigehyst,
                        run_cemaneigehyst_warm, run_icemelt)
from .gr4j import run_gr4j, run_gr4j_warm
from .uh import NUM_UH1, NUM_UH2


def run_cemaneigegr4j(prec, mean_temp, etp, frac_solid_prec, snow_pack_init,
                      thermal_state_init, s_init, r_init, params,
                      num_uh1=NUM_UH1, num_uh2=NUM_UH2, return_final=False):
    """Cemaneige + GR4J for a batch of parameter sets.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing series.
        etp: (T,) potential evapotranspiration.
        snow_pack_init, thermal_state_init: initial snow states.
        s_init, r_init: GR4J store initializations (fractions of x1/x3).
        params: dict of (N,) tensors CTG, Kf, x1..x4.
        return_final: also return ``(snow_final, gr4j_final)`` -- the snow
            routine's ``(G, eTG, g_thresh)`` bundle and the GR4J
            :class:`~.gr4j.GR4JState`.

    Returns:
        (qsim, G, eTG, s_store, r_store); with ``return_final``
        additionally the combined final state.
    """
    liquid_water, G, eTG, *snow_final = run_cemaneige(
        prec, mean_temp, frac_solid_prec, snow_pack_init,
        thermal_state_init, params, return_final=return_final)
    qsim, s_store, r_store, *gr4j_final = run_gr4j(
        liquid_water.T, etp, s_init, r_init, params, num_uh1, num_uh2,
        return_final=return_final)
    if return_final:
        return (qsim, G, eTG, s_store, r_store,
                (snow_final[0], gr4j_final[0]))
    return qsim, G, eTG, s_store, r_store


def run_cemaneigehystgr4j(prec, mean_temp, etp, frac_solid_prec,
                          snow_pack_init, thermal_state_init, sca_init,
                          s_init, r_init, params, num_uh1=NUM_UH1,
                          num_uh2=NUM_UH2, return_final=False):
    """Cemaneige-Hysteresis + GR4J for a batch of parameter sets.

    Returns:
        (qsim, G, eTG, s_store, r_store, sca, rain); with ``return_final``
        additionally ``(snow_final, gr4j_final)`` where ``snow_final`` is
        the ``(G, eTG, sca, swe_max, psol_annual)`` bundle.
    """
    liquid_water, G, eTG, sca, rain, *snow_final = run_cemaneigehyst(
        prec, mean_temp, frac_solid_prec, snow_pack_init,
        thermal_state_init, sca_init, params, return_final=return_final)
    qsim, s_store, r_store, *gr4j_final = run_gr4j(
        liquid_water.T, etp, s_init, r_init, params, num_uh1, num_uh2,
        return_final=return_final)
    if return_final:
        return (qsim, G, eTG, s_store, r_store, sca, rain,
                (snow_final[0], gr4j_final[0]))
    return qsim, G, eTG, s_store, r_store, sca, rain


def _weighted_icemelt(mean_temp, G, frac_ice, params):
    """Glacier melt summed over layers with per-layer ice fractions;
    (N, T)."""
    icemelt_layers = run_icemelt(mean_temp, G, params)
    return (icemelt_layers * frac_ice[None, None, :]).sum(dim=2)


def run_cemaneigegr4jice(prec, mean_temp, etp, frac_ice, frac_solid_prec,
                         snow_pack_init, thermal_state_init, s_init, r_init,
                         params, num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                         return_final=False):
    """Cemaneige + degree-day ice melt + GR4J for a batch of parameter
    sets; ``frac_ice`` is the (L,) glaciated fraction of each layer.

    Returns:
        (qsim, G, eTG, s_store, r_store, icemelt); with ``return_final``
        additionally ``(snow_final, gr4j_final)``.
    """
    snowmelt, G, eTG, *snow_final = run_cemaneige(
        prec, mean_temp, frac_solid_prec, snow_pack_init,
        thermal_state_init, params, return_final=return_final)
    icemelt = _weighted_icemelt(mean_temp, G, frac_ice, params)
    liquid_water = snowmelt + icemelt
    qsim, s_store, r_store, *gr4j_final = run_gr4j(
        liquid_water.T, etp, s_init, r_init, params, num_uh1, num_uh2,
        return_final=return_final)
    if return_final:
        return (qsim, G, eTG, s_store, r_store, icemelt,
                (snow_final[0], gr4j_final[0]))
    return qsim, G, eTG, s_store, r_store, icemelt


def run_cemaneigehystgr4jice(prec, mean_temp, etp, frac_ice,
                             frac_solid_prec, snow_pack_init,
                             thermal_state_init, sca_init, s_init, r_init,
                             params, num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                             return_final=False):
    """Cemaneige-Hysteresis + ice melt + GR4J for a batch of parameter
    sets.

    Returns:
        (qsim, G, eTG, s_store, r_store, sca, icemelt, snowmelt, rain);
        ``snowmelt`` is the (N, T) snow-routine outflow series, matching
        the reference return contract
        (``cemaneigehystgr4jice_model.py:88-104``).  With ``return_final``
        additionally ``(snow_final, gr4j_final)``.
    """
    snowmelt, G, eTG, sca, rain, *snow_final = run_cemaneigehyst(
        prec, mean_temp, frac_solid_prec, snow_pack_init,
        thermal_state_init, sca_init, params, return_final=return_final)
    icemelt = _weighted_icemelt(mean_temp, G, frac_ice, params)
    liquid_water = snowmelt + icemelt
    qsim, s_store, r_store, *gr4j_final = run_gr4j(
        liquid_water.T, etp, s_init, r_init, params, num_uh1, num_uh2,
        return_final=return_final)
    if return_final:
        return (qsim, G, eTG, s_store, r_store, sca, icemelt, snowmelt,
                rain, (snow_final[0], gr4j_final[0]))
    return qsim, G, eTG, s_store, r_store, sca, icemelt, snowmelt, rain


# ---------------------------------------------------------------------------
# Warm continuation (forecast mode): the snow routine's warm scan chained
# into GR4J's, carrying both states.  The data-dependent per-layer constants
# (g_thresh / annual solid precipitation) belong to the ORIGINAL series and
# are supplied explicitly -- see run_cemaneige_warm.
# ---------------------------------------------------------------------------

def run_cemaneigegr4j_warm(prec, mean_temp, etp, frac_solid_prec, state,
                           g_thresh, params, num_uh1=NUM_UH1,
                           num_uh2=NUM_UH2, frac_ice=None):
    """Continue Cemaneige(+ice) + GR4J from carried states.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) continuation forcing.
        etp: (T,) potential evapotranspiration.
        state: ``(snow_state, gr4j_state)`` where ``snow_state`` is the
            ``(G, eTG)`` tuple of (N, L) tensors and ``gr4j_state`` a
            batched :class:`~.gr4j.GR4JState`.
        g_thresh: (L,) or (N, L) snow-cover thresholds of the original
            series.
        frac_ice: (L,) glacier fractions to add degree-day ice melt (the
            Ice composition); None for plain Cemaneige + GR4J.

    Returns:
        (qsim, G, eTG, s_store, r_store, icemelt, final_state);
        ``icemelt`` is the (N, T) weighted glacier-melt series (zeros when
        ``frac_ice`` is None) and ``final_state`` the
        ``((G, eTG), GR4JState)`` pair.
    """
    snow_state, gr4j_state = state
    liquid, G, eTG, snow_final = run_cemaneige_warm(
        prec, mean_temp, frac_solid_prec, snow_state, g_thresh, params)
    if frac_ice is not None:
        icemelt = _weighted_icemelt(mean_temp, G, frac_ice, params)
    else:
        icemelt = torch.zeros_like(liquid)
    liquid = liquid + icemelt
    qsim, s_store, r_store, gr4j_final = run_gr4j_warm(
        liquid.T, etp, gr4j_state, params, num_uh1, num_uh2)
    return (qsim, G, eTG, s_store, r_store, icemelt,
            (snow_final, gr4j_final))


def run_cemaneigehystgr4j_warm(prec, mean_temp, etp, frac_solid_prec, state,
                               psol_annual, params, num_uh1=NUM_UH1,
                               num_uh2=NUM_UH2, frac_ice=None):
    """Continue Cemaneige-Hysteresis(+ice) + GR4J from carried states.

    Args:
        state: ``(snow_state, gr4j_state)`` where ``snow_state`` is the
            ``(G, eTG, sca, swe_max)`` tuple.
        psol_annual: (L,) or (N, L) mean annual solid precipitation of the
            original series.
        frac_ice: (L,) glacier fractions for the Hyst + Ice composition;
            None for Hyst only.

    Returns:
        (qsim, G, eTG, s_store, r_store, sca, rain, icemelt, final_state);
        ``icemelt`` is zeros when ``frac_ice`` is None.
    """
    snow_state, gr4j_state = state
    liquid, G, eTG, sca, rain, snow_final = run_cemaneigehyst_warm(
        prec, mean_temp, frac_solid_prec, snow_state, psol_annual, params)
    if frac_ice is not None:
        icemelt = _weighted_icemelt(mean_temp, G, frac_ice, params)
    else:
        icemelt = torch.zeros_like(liquid)
    liquid = liquid + icemelt
    qsim, s_store, r_store, gr4j_final = run_gr4j_warm(
        liquid.T, etp, gr4j_state, params, num_uh1, num_uh2)
    return (qsim, G, eTG, s_store, r_store, sca, rain, icemelt,
            (snow_final, gr4j_final))
