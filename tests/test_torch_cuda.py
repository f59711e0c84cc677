"""PyTorch port, the hand-written CUDA kernels on an NVIDIA GPU.

Every test here needs the card and skips elsewhere.  The file imports no
JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel (K1 MSE, K2 stats, K3 trajectories) is held against its plain
PyTorch version on the same CUDA tensors.  Tolerances: float64
``rtol=1e-9, atol=1e-12`` (the same operations in another order);
float32 trajectories ``rtol=5e-3, atol=1e-3`` and objectives
``rtol=2e-2`` (rounding compounds over the recurrence; rrmpg_tpu's own
fused-vs-XLA float32 drift is 8.5e-3 relative).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import fused_gr4j as fg

pytestmark = pytest.mark.cuda

DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
TOL = {torch.float64: {"traj": (1e-9, 1e-12), "obj": (1e-9, 1e-12)},
       torch.float32: {"traj": (5e-3, 1e-3), "obj": (2e-2, 0.0)}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(device, dtype, T=500, N=300, x4_max=9.9, gaps=False, seed=0):
    rng = np.random.default_rng(seed)
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::11] = np.nan
    series = [torch.tensor(a, dtype=dtype, device=device)
              for a in (rng.uniform(0, 15, T), rng.uniform(0, 4, T), qobs)]
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_max, N)}
    return (*series, {k: torch.tensor(v, dtype=dtype, device=device)
                      for k, v in params.items()})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("mode", ["traj", "mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_kernel_matches_plain(cuda, dtype, n1, n2, x4_max, mode):
    masked = mode.endswith("masked")
    prec, etp, qobs, params = _inputs(cuda, dtype, x4_max=x4_max,
                                      gaps=masked)
    packed = fg.pack_params(params, 0.4, 0.3)
    fg.reset_launches()
    if mode == "traj":
        got = fg.gr4j_simulate_fused(prec, etp, 0.4, 0.3, params, n1, n2)
        want = fg.gr4j_simulate_reference(prec, etp, packed, n1, n2)
        rtol, atol = TOL[dtype]["traj"]
        kernel = "gr4j_traj"
    else:
        stats = mode.startswith("stats")
        count = int(torch.isfinite(qobs).sum())
        got = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.4, 0.3, params,
                                         n1, n2, stats=stats, masked=masked)
        want = fg.gr4j_objective_reference(prec, etp, qobs, packed, n1, n2,
                                           stats, masked, count)
        rtol, atol = TOL[dtype]["obj"]
        kernel = "gr4j_stats" if stats else "gr4j_mse"
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kernel] == 1
    assert got.device.type == "cuda" and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_golden_excel_trajectory_fused_float64(cuda):
    params = {'x1': np.exp(5.76865628090826),
              'x2': np.sinh(1.61742503661094),
              'x3': np.exp(4.24316129943456),
              'x4': np.exp(-0.117506799276908) + 0.5}
    data = pd.read_csv(os.path.join(DATA_DIR, 'gr4j_example_data.csv'))
    model = GR4J(params=params, device=cuda, dtype=torch.float64)
    qsim = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                          engine='fused')
    assert np.allclose(qsim.cpu().numpy().ravel(), data.qsim_excel)


def test_fit_launches_one_kernel_per_generation(cuda):
    rng = np.random.default_rng(3)
    prec, etp = rng.uniform(0, 15, 400), rng.uniform(0, 4, 400)
    qobs = GR4J(params={'x1': 500.0, 'x2': 0.5, 'x3': 80.0, 'x4': 2.0},
                dtype=torch.float64).simulate(prec, etp).numpy().ravel()
    fg.reset_launches()
    res = GR4J(device=cuda).fit(qobs, prec, etp, engine='fused', seed=0,
                                maxiter=4)
    assert fg.LAUNCHES["gr4j_mse"] == res.nit + 1
    assert np.isfinite(res.fun)


def test_mixed_devices_raise(cuda):
    prec, etp, _, params = _inputs(cuda, torch.float32, N=4, T=10)
    with pytest.raises(ValueError, match="one device"):
        fg.gr4j_simulate_fused(prec.cpu(), etp.cpu(), 0.0, 0.0, params)
