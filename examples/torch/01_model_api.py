"""End-to-end model API walkthrough on the bundled CAMELS basin.

The PyTorch port's counterpart of ``examples/01_model_api.py`` (itself the
reference's model_api_example notebook): load data, split into
calibration/validation periods, calibrate CemaneigeGR4J two ways
(Monte-Carlo and differential evolution), and compare NSE on validation.

On the card (``--device cuda``, the default) the Monte-Carlo and every DE
generation are one launch of the fused snow objective kernel each, and the
validation runs go through the fused trajectory kernel; ``--device cpu``
runs the plain PyTorch engine (``'scan'``).  ``polish=True`` refines DE's
best member by gradient descent where autograd can follow the objective
(``'scan'``); the fused kernels have no backward, so on the card the fit's
message says the polish was skipped.

    python -c "exec(open('examples/torch/01_model_api.py').read(), \
{'__file__': 'examples/torch/01_model_api.py', '__name__': '__main__'})" \
--device cpu
"""

import argparse
import os

import numpy as np

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import CemaneigeGR4J
from rrmpg_tpu_torch.tools import monte_carlo
from rrmpg_tpu_torch.utils import calc_nse

# CI fast mode: tiny sizes so the example executes end-to-end in seconds;
# the didactic sizes are the defaults.  It also cuts the polish to 2 Adam
# steps (200 by default): on the CPU each step differentiates through the
# 'scan' engine's 5479-day loop, about 10 s.
FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the fused kernels) or 'cpu' (plain "
                        "PyTorch)")
    return parser.parse_args(argv)


def forcings(df, height):
    return dict(prec=df['prcp(mm/day)'], mean_temp=(df['tmax(C)'] +
                                                    df['tmin(C)']) / 2,
                min_temp=df['tmin(C)'], max_temp=df['tmax(C)'],
                etp=df['PET'], met_station_height=height)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    engine = "fused" if device.type == "cuda" else "scan"

    loader = CAMELSLoader()
    df = loader.load_basin('01031500')
    height = loader.get_station_height('01031500')

    # First 15 hydrological years calibrate, the rest validate (exact
    # Sep-30 / Oct-1 split as in the reference notebook).
    end_cal = f"{df.index[0].year + 15}-09-30"
    start_val = f"{df.index[0].year + 15}-10-01"
    cal, val = df[:end_cal], df[start_val:]
    qobs_val = val['QObs(mm/d)'].to_numpy()

    model = CemaneigeGR4J(device=device)

    # --- Monte Carlo: 10k random parameter sets; only the scores are
    # kept, so on the card no trajectory is ever written ---
    num = 500 if FAST else 10_000
    mc = monte_carlo(model, num=num, qobs=cal['QObs(mm/d)'].to_numpy(),
                     return_qsim=False, engine=engine,
                     **forcings(cal, height))
    best = int(np.argmin(mc['mse']))
    model.set_params(mc['params'][best])
    qsim_val = model.simulate(**forcings(val, height), engine=engine)
    nse_mc = calc_nse(qobs_val, qsim_val[:, 0])
    print(f"Monte-Carlo best-of-{num}:  cal MSE {mc['mse'][best]:.3f}  "
          f"val NSE {nse_mc:.4f}")

    # --- Differential evolution on the device, with the gradient polish
    # step that scipy's L-BFGS-B polish corresponds to ---
    res = model.fit(cal['QObs(mm/d)'].to_numpy(), seed=0, polish=True,
                    polish_steps=2 if FAST else 200,
                    maxiter=5 if FAST else 1000, engine=engine,
                    **forcings(cal, height))
    model.set_params({p: float(v) for p, v in
                      zip(model.get_parameter_names(), res.x)})
    qsim_val = model.simulate(**forcings(val, height), engine=engine)
    nse_de = calc_nse(qobs_val, qsim_val[:, 0])
    print(f"DE calibration:           cal MSE {res.fun:.3f}  "
          f"(nfev {res.nfev})  val NSE {nse_de:.4f}")
    print(f"  {res.message}")
    return {"mc_cal_mse": float(mc['mse'][best]), "mc_val_nse": nse_mc,
            "de_cal_mse": float(res.fun), "de_nfev": int(res.nfev),
            "de_val_nse": nse_de, "de_x": np.asarray(res.x)}


if __name__ == "__main__":
    main()
