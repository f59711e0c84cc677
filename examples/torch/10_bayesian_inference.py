"""Bayesian parameter inference on a real basin (DE-MC posterior).

The PyTorch port's counterpart of ``examples/10_bayesian_inference.py``.
GLUE (example 05) weights a Monte-Carlo ensemble informally; this example
runs formal MCMC instead: DE-MC (``rrmpg_tpu_torch.tools.demc_sample``,
the DREAM-family algorithm) samples the joint posterior of GR4J's four
parameters *and* an unknown observation-noise scale on five years of
CAMELS basin 01031500, giving calibrated credible intervals.  All chains
step together as one batched evaluation, one call of
``ops.gr4j_ensemble_mse_fused`` per half-step (the sum of squared errors is
T times the MSE): on the card one launch of the fused GR4J MSE kernel, on
the CPU its plain version.  A time printed on the
card stands beside the card's name and power limit as ``nvidia-smi``
reports them.

    python -c "exec(open('examples/torch/10_bayesian_inference.py').read(), \
{'__file__': 'examples/torch/10_bayesian_inference.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import math
import os
import subprocess
import time

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused
from rrmpg_tpu_torch.tools import demc_sample

FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the fused kernels) or 'cpu' (plain "
                        "PyTorch)")
    return parser.parse_args(argv)


def device_label(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[device.index or 0]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    df = CAMELSLoader().load_basin('01031500')
    T = 365 if FAST else 1825
    prec, etp, qobs = (
        torch.tensor(df[c].values[:T], dtype=torch.float32, device=device)
        for c in ('prcp(mm/day)', 'PET', 'QObs(mm/d)'))

    model = GR4J(device=device)
    param_names = list(model.get_parameter_names())
    names = param_names + ['sigma']
    bounds = [model.get_default_bounds()[p] for p in param_names]
    bounds.append((0.05, 5.0))  # observation-noise scale, sampled too
    x4_hi = bounds[param_names.index('x4')][1]
    uh = dict(num_uh1=math.ceil(x4_hi), num_uh2=math.ceil(2 * x4_hi + 1))

    def log_prob(X):
        """(C, 5) chain states -> (C,) log-posterior, one batched call."""
        params = {n: X[:, j].contiguous()
                  for j, n in enumerate(param_names)}
        sigma = X[:, 4]
        sse = T * gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0, params,
                                          **uh)
        # Gaussian likelihood with unknown sigma (Jeffreys-ish via the
        # explicit -T log sigma term).
        return -0.5 * sse / sigma ** 2 - T * torch.log(sigma)

    chains, steps = (32, 400) if FAST else (128, 8000)
    t0 = time.perf_counter()
    res = demc_sample(log_prob, bounds, num_chains=chains, num_steps=steps,
                      burn_in=0.6, seed=0, batched=True, device=device)
    wall = time.perf_counter() - t0
    print(f"acceptance {res.acceptance_rate:.2f}, max R-hat "
          f"{np.nanmax(res.r_hat):.3f} ({chains} chains x {steps} steps, "
          f"{wall:.1f} s; {device_label(device)})")

    flat = res.flat()
    lo, med, hi = np.percentile(flat, [2.5, 50, 97.5], axis=0)
    print("posterior (median [2.5%, 97.5%]):")
    for i, name in enumerate(names):
        print(f"  {name:<5s} {med[i]:.4g} [{lo[i]:.4g}, {hi[i]:.4g}]")
    return {"acceptance_rate": float(res.acceptance_rate),
            "max_r_hat": float(np.nanmax(res.r_hat)), "median": med,
            "lower": lo, "upper": hi}


if __name__ == "__main__":
    main()
