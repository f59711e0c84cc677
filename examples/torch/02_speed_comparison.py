"""The reference's headline speed benchmark, on the card's ABC kernels.

The reference compares pure Python (5.83 s), numba (33.3 ms) and Fortran
(23.7 ms) on 10M ABC-model timesteps (its published CPU times,
``docs/source/examples/speed_comparision.rst``).  The PyTorch port's
counterpart of ``examples/02_speed_comparison.py`` runs the same
simulation two ways -- the chunked Toeplitz products
``run_abcmodel_matscan`` (the ``'scan'`` engine, as JAX's XLA engine) and,
on the card, the hand-written one-launch chunked scan
``abc_fused_single`` -- and then as a batched ensemble, 1024 parameter
sets over 1M steps each (on the card the three-launch ``abc_fused``),
which is where an accelerator earns its keep.

Timing: ``utils.profiling.benchmark`` -- one first call (the kernel
library is built and loaded there), then the best of three runs, each
ended once the card has finished.  A time printed on the card stands beside
the card's name and power limit as ``nvidia-smi`` reports them.

    python -c "exec(open('examples/torch/02_speed_comparison.py').read(), \
{'__file__': 'examples/torch/02_speed_comparison.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import os
import subprocess

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.ops import (abc_fused, abc_fused_single,
                                 run_abcmodel_matscan)
from rrmpg_tpu_torch.utils.profiling import benchmark

NUMBA_MS = 33.3   # the reference's published numba time

# CI fast mode: tiny sizes so the example executes end-to-end in seconds;
# the benchmark sizes are the defaults.
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
    label = device_label(device)

    T = 500_000 if FAST else 10_000_000
    rng = np.random.default_rng(0)
    prec = torch.as_tensor(rng.uniform(0, 20, T), dtype=torch.float32,
                           device=device)
    params = {k: torch.tensor(v, dtype=torch.float32, device=device)
              for k, v in (('a', 0.3), ('b', 0.2), ('c', 0.15))}
    s0 = torch.tensor(0.0, dtype=torch.float32, device=device)

    engines = {"scan: Toeplitz products": run_abcmodel_matscan}
    if device.type == "cuda":
        engines["fused: one-launch chunked scan (K6)"] = abc_fused_single

    results, outputs = {}, {}
    for name, kernel in engines.items():
        res = benchmark(kernel, prec, s0, params, repeats=3)
        outputs[name] = kernel(prec, s0, params)
        print(f"ABC {T:.0e} steps [{name}]: first call "
              f"{res.compile_s:.2f} s, {res.best_s * 1e3:.3f} ms/sim = "
              f"{T / res.best_s:.3e} steps/s "
              f"({NUMBA_MS / (res.best_s * 1e3):.0f}x the reference's "
              f"numba); {label}")
        results[name] = float(outputs[name][1][-1])
    ref_q = outputs["scan: Toeplitz products"][0]
    diff = max(float((q - ref_q).abs().max()) for q, _ in outputs.values())
    print(f"final storage {results}; max |dq| between engines {diff:.2e}")

    # Ensemble version: 1024 parameter sets over 1M steps each.
    N, T_e = (64, 50_000) if FAST else (1024, 1_000_000)
    prec_e = torch.as_tensor(rng.uniform(0, 20, T_e), dtype=torch.float32,
                             device=device)
    batch = {k: torch.as_tensor(rng.uniform(0.05, 0.45, N),
                                dtype=torch.float32, device=device)
             for k in ('a', 'b', 'c')}
    s0_e = torch.zeros(N, dtype=torch.float32, device=device)
    kernel = abc_fused if device.type == "cuda" else run_abcmodel_matscan
    res_e = benchmark(kernel, prec_e, s0_e, batch, repeats=3)
    q_e, s_e = kernel(prec_e, s0_e, batch)
    print(f"ABC ensemble {N}x{T_e} [{kernel.__name__}]: best "
          f"{res_e.best_s * 1e3:.1f} ms "
          f"({res_e.throughput(N * T_e):.3e} catchment-steps/s); {label}")
    return {"steps": T, "final_storage": results, "max_dq": diff,
            "q_max": float(ref_q.abs().max()),
            "ensemble_shape": tuple(q_e.shape),
            "ensemble_finite": bool(torch.isfinite(q_e).all()
                                    and torch.isfinite(s_e).all())}


if __name__ == "__main__":
    main()
