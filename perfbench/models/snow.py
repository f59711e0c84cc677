"""CemaNeige with hysteresis and glacier ice melt before GR4J on elevation
layers of a CAMELS basin: the inputs the benchmark makes, the program's
entry point it calls, and the plain reference that judges it.

The layer forcing is made here with NumPy, after the Cemaneige-Excel /
airGR extrapolation (kratzert/RRMPG ``cemaneige_utils.py``): precipitation
grows by exp(0.0004 dz) up to 4000 m, temperature falls by 0.0065 degC a
metre, and the solid fraction comes from the daily minimum and maximum
below 1500 m and from the mean above.  Both sides get the same (T, L)
arrays, the program as tensors in the configuration's dtype, the reference
the same values in float64.
"""

import numpy as np
import torch

from perfbench.census import snow as census
from perfbench.models.gr4j import bounds, dtype_of, record
from perfbench.reference import snow as reference

PARAMS = reference.PARAMS

# As ``perfbench.models.gr4j.ENTRIES``.
ENTRIES = {
    "mc": ("rrmpg_tpu_torch.ops", "snowgr4j_ensemble_mse_fused",
           {0: 0, 1: 0, 2: 0, 3: 0, 4: 0}),
}


def layer_forcing(rec, station, altitudes):
    """(T, L) precipitation, mean temperature and solid fraction of the
    layers at ``altitudes`` from the station series of ``rec``."""
    z = np.asarray(altitudes, np.float64)[None, :]
    cap = np.exp((4000.0 - station) * 0.0004) if station <= 4000 else 1.0
    factor = np.where(z <= 4000.0, np.exp((z - station) * 0.0004), cap)
    prec = rec["prec"][:, None] * factor
    dz = (z - station) * -0.0065
    tmin, tmax = rec["tmin"][:, None] + dz, rec["tmax"][:, None] + dz
    tmean = 0.5 * (rec["tmin"] + rec["tmax"])[:, None] + dz
    spread = tmax - tmin
    low = 1.0 - tmax / np.where(spread == 0.0, 1.0, spread)
    low = np.where(tmax <= 0.0, 1.0, np.where(tmin >= 0.0, 0.0, low))
    high = 1.0 - (tmean + 1.0) / 4.0
    high = np.where(tmean >= 3.0, 0.0, np.where(tmean <= 0.0, 1.0, high))
    frac = np.where(z < 1500.0, low, high)
    return prec, tmean, frac


class Objective:
    """The fused coupled-model objective (K8) over the first ``days`` days
    of the record, and the reference's time means."""

    params = PARAMS

    def __init__(self, cfg, days, device):
        if not (cfg["hyst"] and cfg["ice"]):
            raise ValueError("the snow reference is the hysteresis + ice "
                             "composition.")
        self.cfg, self.uh = cfg, tuple(cfg["uh"])
        dtype = dtype_of(cfg)
        rec = {k: v[:days] for k, v in record(cfg).items()}
        prec, tmean, frac = layer_forcing(rec, cfg["met_station_height"],
                                          cfg["altitudes"])
        arrays = {"prec": prec, "mean_temp": tmean, "frac_solid": frac,
                  "etp": rec["etp"], "qobs": rec["qobs"],
                  "frac_ice": np.asarray(cfg["frac_ice"], np.float64)}
        self.series = {k: torch.tensor(v, dtype=dtype, device=device)
                       for k, v in arrays.items()}
        self.qobs = self.series["qobs"]
        self.masked = bool(torch.isnan(self.qobs).any())
        self.layers = len(cfg["altitudes"])
        self.lows, self.span = bounds(cfg, PARAMS, device, dtype)

    def program_stats(self, params):
        from rrmpg_tpu_torch import ops

        s, i = self.series, self.cfg["inits"]
        return ops.snowgr4j_ensemble_mse_fused(
            s["prec"], s["mean_temp"], s["etp"], s["frac_solid"], s["qobs"],
            i["snow_pack_init"], i["thermal_state_init"], i["s_init"],
            i["r_init"], params, frac_ice=s["frac_ice"],
            hyst=self.cfg["hyst"], ice=self.cfg["ice"], stats=True,
            num_uh1=self.uh[0], num_uh2=self.uh[1], masked=self.masked)

    def reference_stats(self, params, dtype=torch.float64):
        """(4, M) time means of (M,) float64 ``params`` by the reference,
        computed in ``dtype`` on the host from the program's inputs."""
        s = {k: v.to("cpu", torch.float64).to(dtype)
             for k, v in self.series.items()}
        p = {k: v.to(dtype) for k, v in params.items()}
        return reference.objective_stats(
            s["prec"], s["mean_temp"], s["frac_solid"], s["etp"], s["qobs"],
            s["frac_ice"], p, self.cfg["inits"], *self.uh)

    def member_day_ops(self):
        return census.member_day_ops(self.layers, self.cfg["hyst"],
                                     self.cfg["ice"], self.uh)
