"""PyTorch port, CemaneigeGR4JIce through its class API against the C++
oracle composition (CPU, float64).

The counterpart of ``tests/test_ice_composition_oracle.py`` for the port:
the reference ships no golden data for this class, so the port's whole
class path (validation, its own elevation-layer extrapolation and solid
fraction, the composed kernels) is held to a composition of the
independent C++ oracle kernels of ``rrmpg_tpu/native`` (snow routine, ice
melt, GR4J), fed with the port's met preprocessing.  Both engines: the
sequential ops and the fused kernel's plain version.
"""

import numpy as np
import pytest
import torch

from rrmpg_tpu import native
from rrmpg_tpu_torch.models import CemaneigeGR4JIce
from rrmpg_tpu_torch.ops.met import (calculate_solid_fraction,
                                     extrapolate_precipitation,
                                     extrapolate_temperature)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable")


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_cemaneigegr4jice_class_vs_cpp_oracle(engine):
    rng = np.random.default_rng(17)
    T = 600
    prec = rng.uniform(0, 15, T)
    mean_t = rng.uniform(-10, 12, T)
    min_t = mean_t - rng.uniform(0, 5, T)
    max_t = mean_t + rng.uniform(0, 5, T)
    etp = rng.uniform(0, 4, T)
    altitudes = [550, 620, 700, 785, 920]
    station = 495
    frac_ice = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    params = {'CTG': 0.3, 'Kf': 4.0, 'x1': 310.0, 'x2': 0.9, 'x3': 95.0,
              'x4': 2.2, 'DDF': 6.0}

    qsim = CemaneigeGR4JIce(params=params, device='cpu',
                            dtype=torch.float64).simulate(
        prec, mean_t, min_t, max_t, etp, frac_ice,
        met_station_height=station, altitudes=altitudes, s_init=0.4,
        r_init=0.3, engine=engine)[:, 0].numpy()

    # Oracle composition: the port's met preprocessing feeding the chained
    # C++ kernels.
    alts = np.asarray(altitudes, np.float64)
    t = {k: torch.from_numpy(v) for k, v in
         (("prec", prec), ("min", min_t), ("mean", mean_t), ("max", max_t))}
    prec_l = extrapolate_precipitation(t["prec"], alts, station)
    min_l, mean_l, max_l = extrapolate_temperature(t["min"], t["mean"],
                                                   t["max"], alts, station)
    frac = calculate_solid_fraction(prec_l, alts, mean_l, min_l, max_l)
    prec_l, mean_l, frac = (x.numpy() for x in (prec_l, mean_l, frac))
    snowmelt, G, _ = native.oracle_cemaneige(prec_l, mean_l, frac, 0.0,
                                             0.0, params)
    icemelt = native.oracle_icemelt(mean_l, G, params)
    liquid = snowmelt + np.sum(icemelt * frac_ice[None, :], axis=1)
    q_ref, _, _ = native.oracle_gr4j(liquid, etp, 0.4, 0.3, params)

    assert np.isfinite(qsim).all()
    np.testing.assert_allclose(qsim, q_ref, rtol=1e-10, atol=1e-12)
