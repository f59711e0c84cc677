"""GLUE uncertainty bands and regional multi-catchment sweeps.

The PyTorch port's counterpart of ``examples/05_uncertainty_regional.py``.
Capabilities beyond the reference package:

* GLUE (Beven & Binley 1992) likelihood weighting over a Monte-Carlo
  ensemble on the bundled CAMELS basin, with weighted 90% prediction
  limits and their coverage of the observations (on the card the
  ensemble's trajectories come from the fused snow trajectory kernel);
* a regional (catchment x member) GR4J objective sweep evaluated on the
  card by the fused regional kernel -- one number per (catchment, member)
  pair -- also over ragged records with gaps.

    python -c "exec(open('examples/torch/05_uncertainty_regional.py').read(), \
{'__file__': 'examples/torch/05_uncertainty_regional.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import os

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import CemaneigeGR4J
from rrmpg_tpu_torch.parallel.regional import regional_gr4j_objective
from rrmpg_tpu_torch.tools import glue_weights, monte_carlo, prediction_limits

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

    loader = CAMELSLoader()
    df = loader.load_basin('01031500').iloc[:731 if FAST else 3652]
    height = loader.get_station_height('01031500')
    qobs = df['QObs(mm/d)'].to_numpy()
    prec = df['prcp(mm/day)'].to_numpy()
    etp = df['PET'].to_numpy()

    # --- GLUE over a Monte-Carlo ensemble (snow-aware model) ---
    model = CemaneigeGR4J(device=device)
    num = 1000 if FAST else 20_000
    mc = monte_carlo(model, num=num, qobs=qobs, prec=prec, etp=etp,
                     mean_temp=(df['tmax(C)'] + df['tmin(C)']) / 2,
                     min_temp=df['tmin(C)'], max_temp=df['tmax(C)'],
                     met_station_height=height, metrics=('nse',),
                     engine=engine)
    weights = glue_weights(mc['nse'], behavioral_threshold=0.3,
                           device=device)
    n_behavioral = int((weights > 0).sum())
    lo, med, hi = prediction_limits(mc['qsim'], weights,
                                    quantiles=(0.05, 0.5, 0.95),
                                    device=device)
    coverage = float(np.mean((qobs >= lo) & (qobs <= hi)))
    print(f"GLUE: {n_behavioral} behavioral of {num} (NSE > 0.3); "
          f"90% band covers {coverage:.1%} of observations; "
          f"best NSE {np.nanmax(mc['nse']):.3f}")

    # --- Regional sweep: catchment x member cross product ---
    # Synthesize a small region by perturbing the basin's forcing.
    rng = np.random.default_rng(0)
    C, N = (4, 256) if FAST else (4, 4096)
    prec_ct = np.stack([prec * rng.uniform(0.8, 1.2) for _ in range(C)])
    etp_ct = np.stack([etp * rng.uniform(0.9, 1.1) for _ in range(C)])
    qobs_ct = np.stack([qobs for _ in range(C)])
    params = model.sample_params(
        torch.Generator(device=device).manual_seed(1), N)
    losses = regional_gr4j_objective(
        prec_ct, etp_ct, qobs_ct, 0.3, 0.3, params,
        engine=engine).cpu().numpy()
    print(f"regional sweep [{engine}]: {C} catchments x {N} members -> "
          f"losses {losses.shape}; per-catchment best MSE "
          f"{np.round(losses.min(axis=1).astype(float), 3).tolist()}")

    # --- Ragged records: real regional studies have gauges with
    # different periods of record and in-record gaps (CAMELS encodes
    # missing discharge as -999; the loader converts it to NaN and
    # load_basins(join='outer') NaN-pads unequal records). NaN
    # observations are masked per catchment -- each loss normalizes
    # over its own valid days -- so the sweep just works.
    qobs_ragged = qobs_ct.copy()
    qobs_ragged[0, qobs.shape[0] // 2:] = np.nan   # gauge decommissioned
    qobs_ragged[1, rng.random(qobs.shape[0]) < 0.1] = np.nan  # 10% gaps
    losses_m = regional_gr4j_objective(
        prec_ct, etp_ct, qobs_ragged, 0.3, 0.3, params,
        engine=engine).cpu().numpy()
    n_valid = np.isfinite(qobs_ragged).sum(axis=1)
    best_m = np.round(losses_m.min(axis=1).astype(float), 3).tolist()
    print(f"ragged records: valid days {n_valid.tolist()} -> masked "
          f"per-catchment best MSE {best_m} (all finite: "
          f"{bool(np.isfinite(losses_m).all())})")
    return {"n_behavioral": n_behavioral, "coverage": coverage,
            "best_nse": float(np.nanmax(mc['nse'])),
            "regional_best": losses.min(axis=1),
            "ragged_best": losses_m.min(axis=1),
            "ragged_finite": bool(np.isfinite(losses_m).all())}


if __name__ == "__main__":
    main()
