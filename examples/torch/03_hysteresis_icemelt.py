"""Hysteresis + ice-melt tutorial on the real Alpine catchment.

The PyTorch port's counterpart of ``examples/03_hysteresis_icemelt.py``,
which mirrors the reference's Tutorial_Hysteresis_IceMelt notebook using
the same bundled 732-day Alpine dataset (``examples/data/
hyst_ice_input.csv``, discharge + five MODIS NDSI snow-cover bands),
elevation bands and glacier fractions.  Three model variants are
calibrated exactly as in the tutorial -- multi-objective Q+SCA with KGE
loss for the hysteresis variants, discharge-only MSE for the ice variant
-- and evaluated by discharge KGE.  On the card every DE generation is one
launch of the fused snow objective kernel (with the snow-cover statistics
for Q+SCA) and the evaluation runs go through the fused trajectory kernel.

Published reference results to compare against
(``Tutorial_Hysteresis_IceMelt.rst:204-209,524-526``):
fit_Q_SCA fun 0.1777 (nfev 14440); KGE Hyst+Ice 0.9133, Hyst 0.8765,
Ice 0.8541.

    python -c "exec(open('examples/torch/03_hysteresis_icemelt.py').read(), \
{'__file__': 'examples/torch/03_hysteresis_icemelt.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import os

import numpy as np
import pandas as pd

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.models import (
    CemaneigeGR4JIce,
    CemaneigeHystGR4J,
    CemaneigeHystGR4JIce,
)
from rrmpg_tpu_torch.utils import calc_kge

ELEVATION = [2277.84423828125, 2641.563720703125, 2845.09521484375,
             3002.329833984375, 3227.36669921875]
MEAN_ELEV = 2798.84033203125
FRAC_ICE = np.array([0.022034026, 0.042062109, 0.246620231, 0.507329678,
                     0.709368134])

# CI fast mode: few-generation calibrations so the example executes
# end-to-end in seconds; the tutorial-quality calibration budget is the
# default.
FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the fused kernels) or 'cpu' (plain "
                        "PyTorch)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    engine = "fused" if device.type == "cuda" else "scan"
    fit_kw = dict(maxiter=3) if FAST else {}

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "data", "hyst_ice_input.csv")
    df = pd.read_csv(path, index_col="Date", sep=";", decimal=".",
                     parse_dates=["Date"])
    # Convert each MODIS NDSI band to snow-covered area before calibrating,
    # as the tutorial does (Tutorial_Hysteresis_IceMelt.rst:182-187):
    # SCA = 0.06 + 1.21 * NDSI, clipped at 100.
    ndsi = [(0.06 + 1.21 * df[f"NDSI{b}"]).clip(upper=100)
            for b in range(1, 6)]
    common = dict(met_station_height=MEAN_ELEV, altitudes=ELEVATION,
                  s_init=0.5, r_init=0.4)
    met = [df['P'], df['Tmean'], df['Tmin'], df['Tmax'], df['ET0']]
    qobs = df["Qmm"].to_numpy()

    results = {}

    # --- Hyst + Ice: multi-objective Q+SCA, KGE loss ---
    m1 = CemaneigeHystGR4JIce(device=device)
    res = m1.fit_Q_SCA(df["Qmm"], *met, FRAC_ICE, *ndsi,
                       loss_metric="kge", sca_init=0.2, seed=0,
                       engine=engine, **common, **fit_kw)
    m1.set_params(dict(zip(m1.get_parameter_names(), map(float, res.x))))
    qsim = m1.simulate(*met, FRAC_ICE, sca_init=0.2, engine=engine,
                       **common)[:, 0]
    results["Hyst+Ice"] = (res, calc_kge(qobs, qsim))

    # --- Hyst (no ice): multi-objective Q+SCA, KGE loss ---
    m2 = CemaneigeHystGR4J(device=device)
    res = m2.fit_Q_SCA(df["Qmm"], *met, *ndsi, loss_metric="kge",
                       sca_init=0.2, seed=0, engine=engine, **common,
                       **fit_kw)
    m2.set_params(dict(zip(m2.get_parameter_names(), map(float, res.x))))
    qsim = m2.simulate(*met, sca_init=0.2, engine=engine, **common)[:, 0]
    results["Hyst"] = (res, calc_kge(qobs, qsim))

    # --- Ice (no hysteresis): discharge-only MSE ---
    m3 = CemaneigeGR4JIce(device=device)
    res = m3.fit(df["Qmm"], *met, FRAC_ICE, seed=0, engine=engine,
                 **common, **fit_kw)
    m3.set_params(dict(zip(m3.get_parameter_names(), map(float, res.x))))
    qsim = m3.simulate(*met, FRAC_ICE, engine=engine, **common)[:, 0]
    results["Ice"] = (res, calc_kge(qobs, qsim))

    published = {"Hyst+Ice": 0.9133, "Hyst": 0.8765, "Ice": 0.8541}
    for name, (res, kge) in results.items():
        print(f"{name:9s}: fit fun={res.fun:.4f} nfev={res.nfev:6d} "
              f"KGE={kge:.4f}  (reference notebook: {published[name]})")
    return {name: {"fun": float(res.fun), "nfev": int(res.nfev),
                   "kge": kge} for name, (res, kge) in results.items()}


if __name__ == "__main__":
    main()
