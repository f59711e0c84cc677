"""Global sensitivity analysis, then calibration with SCE-UA.

The PyTorch port's counterpart of ``examples/07_sensitivity.py``.  No
reference counterpart -- RRMPG users run SALib serially around
``model.simulate``.  Here the whole Saltelli/Morris design is a few batched
evaluations, each one call of ``ops.gr4j_ensemble_mse_fused`` over the
whole design: on the card one launch of the fused GR4J MSE kernel, on the
CPU its plain version.  Screening plus a full
variance decomposition of GR4J on five years of CAMELS forcing, then the
calibration that follows with either optimizer family
(``method='de'`` / ``method='sce'``).

GSA responds to the *variance* of the output: raw MSE has a heavy right
tail (a few terrible parameter sets own all the variance and drown the
indices in noise), so the objective is log(MSE), the standard transform
for error-metric responses.

    python -c "exec(open('examples/torch/07_sensitivity.py').read(), \
{'__file__': 'examples/torch/07_sensitivity.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import math
import os

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused
from rrmpg_tpu_torch.tools import morris_screening, sobol_indices

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

    df = CAMELSLoader().load_basin('01031500')
    T = 365 if FAST else 1825  # five hydrological years
    np_prec = df['prcp(mm/day)'].values[:T]
    np_etp = df['PET'].values[:T]
    np_qobs = df['QObs(mm/d)'].values[:T]
    prec, etp, qobs = (torch.tensor(a, dtype=torch.float32, device=device)
                       for a in (np_prec, np_etp, np_qobs))

    model = GR4J(device=device)
    names = tuple(model.get_parameter_names())
    bounds = [model.get_default_bounds()[p] for p in names]
    # UH lengths that cover every x4 within its bound.
    x4_hi = bounds[names.index('x4')][1]
    uh = dict(num_uh1=math.ceil(x4_hi), num_uh2=math.ceil(2 * x4_hi + 1))

    def objective(X):
        """(P, 4) parameter sets -> (P,) log(MSE), one batched call."""
        params = {n: X[:, j].contiguous() for j, n in enumerate(names)}
        return torch.log(gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0,
                                                 params, **uh))

    # ------------------------------------------------------------------
    # 1. Morris screening: which parameters move the objective at all?
    #    64 trajectories x (dim+1) = 320 model runs, one batched call.
    # ------------------------------------------------------------------
    n_traj = 16 if FAST else 64
    scr = morris_screening(objective, bounds, num_trajectories=n_traj,
                           seed=0, names=names, batched=True,
                           batch_size=512, device=device)
    print(f"Morris screen ({n_traj} trajectories, {scr.nfev} runs):")
    for i in np.argsort(-scr.mu_star):
        print(f"  {scr.names[i]:<4s}  mu* = {scr.mu_star[i]:.3f}  "
              f"sigma = {scr.sigma[i]:.3f}")

    # ------------------------------------------------------------------
    # 2. Sobol' variance decomposition (Saltelli design): how much MSE
    #    variance does each parameter own, alone and with interactions?
    # ------------------------------------------------------------------
    res = sobol_indices(objective, bounds, n=128 if FAST else 1024,
                        seed=0, names=names, batched=True, batch_size=2048,
                        device=device)
    print(f"Sobol' indices (n={res.n}, {res.nfev} runs):")
    for i, name in enumerate(res.names):
        print(f"  {name:<4s}  S1 = {res.s1[i]:.2f}+-{res.s1_conf[i]:.2f}"
              f"   ST = {res.st[i]:.2f}")
    print(f"interactions: sum(S1) = {res.s1.sum():.2f}, "
          f"sum(ST) = {res.st.sum():.2f}")

    # ------------------------------------------------------------------
    # 3. Calibrate: the device-resident DE vs the hydrology-standard
    #    SCE-UA, through the same fit API.
    # ------------------------------------------------------------------
    it = 10 if FAST else 80
    de = model.fit(np_qobs, np_prec, np_etp, seed=0, maxiter=it,
                   engine=engine)
    sce = model.fit(np_qobs, np_prec, np_etp, seed=0, method='sce',
                    maxiter=it, n_complexes=8, engine=engine)
    print(f"DE  fit: mse = {de.fun:.4f}, nfev = {de.nfev}")
    print(f"SCE fit: mse = {sce.fun:.4f}, nfev = {sce.nfev}")
    return {"mu_star": np.asarray(scr.mu_star), "s1": np.asarray(res.s1),
            "st": np.asarray(res.st), "de_mse": float(de.fun),
            "de_nfev": int(de.nfev), "sce_mse": float(sce.fun),
            "sce_nfev": int(sce.nfev)}


if __name__ == "__main__":
    main()
