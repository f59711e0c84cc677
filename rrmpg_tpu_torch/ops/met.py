"""Meteorological preprocessing: elevation-layer extrapolation and the
solid-precipitation fraction.

Counterpart of ``rrmpg_tpu/ops/met.py`` (reference
``rrmpg/models/cemaneige_utils.py:15-208``): elementwise expressions over
a (T, L) grid of time steps and elevation layers.

Physics constants follow the airGR / Cemaneige-Excel conventions used by
the reference: 1500 m solid-fraction regime threshold, 4000 m precipitation
cap, +0.0004 1/m precipitation gradient, -0.0065 degC/m lapse rate.
"""

import torch

Z_SOLID_FRACTION_THRESH = 1500.0
Z_PRECIP_CAP = 4000.0
BETA_ALTITUDE = 0.0004
THETA_TEMP = -0.0065


def calculate_solid_fraction(prec, altitudes, mean_temp, min_temp, max_temp):
    """Fraction of solid precipitation per (timestep, layer).

    airGR rule (reference ``cemaneige_utils.py:49-98``): below 1500 m the
    fraction comes from min/max temperature bracketing; at or above 1500 m
    from the mean temperature bracketed by [0, 3] degC.

    Args:
        prec: (T, L) precipitation (only used for shape/dtype).
        altitudes: (L,) median layer elevations.
        mean_temp, min_temp, max_temp: (T, L) temperature series.

    Returns:
        (T, L) solid fraction in [0, 1].
    """
    del prec
    altitudes = torch.as_tensor(altitudes, dtype=mean_temp.dtype,
                                device=mean_temp.device)
    # Low-elevation rule: bracket by daily min/max temperature.
    spread = max_temp - min_temp
    safe_spread = torch.where(spread == 0, 1.0, spread)
    frac_low = 1.0 - max_temp / safe_spread
    frac_low = torch.where(max_temp <= 0, 1.0,
                           torch.where(min_temp >= 0, 0.0, frac_low))

    # High-elevation rule: bracket mean temperature by [0, 3] degC.
    frac_high = 1.0 - (mean_temp + 1.0) / 4.0
    frac_high = torch.where(mean_temp >= 3, 0.0,
                            torch.where(mean_temp <= 0, 1.0, frac_high))

    low_layer = altitudes < Z_SOLID_FRACTION_THRESH
    return torch.where(low_layer[None, :], frac_low, frac_high)


def extrapolate_precipitation(prec, altitudes, met_station_height):
    """Extrapolate station precipitation to each elevation layer.

    Cemaneige-Excel scheme (reference ``cemaneige_utils.py:100-158``):
    exponential growth with elevation difference, capped at 4000 m.

    Args:
        prec: (T,) station precipitation.
        altitudes: (L,) median layer elevations.
        met_station_height: scalar station elevation.

    Returns:
        (T, L) layer precipitation.
    """
    altitudes = torch.as_tensor(altitudes, dtype=prec.dtype,
                                device=prec.device)
    station = torch.as_tensor(met_station_height, dtype=prec.dtype,
                              device=prec.device)

    factor_below = torch.exp((altitudes - station) * BETA_ALTITUDE)
    factor_cap = torch.where(
        station <= Z_PRECIP_CAP,
        torch.exp((Z_PRECIP_CAP - station) * BETA_ALTITUDE), 1.0)
    factor = torch.where(altitudes <= Z_PRECIP_CAP, factor_below, factor_cap)
    return prec[:, None] * factor[None, :]


def extrapolate_temperature(min_temp, mean_temp, max_temp, altitudes,
                            met_station_height):
    """Extrapolate station temperatures to each elevation layer.

    Linear lapse rate of -0.0065 degC/m (reference
    ``cemaneige_utils.py:160-208``).

    Returns:
        (layer_min, layer_mean, layer_max): three (T, L) tensors.
    """
    altitudes = torch.as_tensor(altitudes, dtype=mean_temp.dtype,
                                device=mean_temp.device)
    station = torch.as_tensor(met_station_height, dtype=mean_temp.dtype,
                              device=mean_temp.device)

    delta = (altitudes - station) * THETA_TEMP
    return (min_temp[:, None] + delta[None, :],
            mean_temp[:, None] + delta[None, :],
            max_temp[:, None] + delta[None, :])
