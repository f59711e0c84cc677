"""PyTorch port, quality parity of its DE against scipy's (CPU, float64).

Counterpart of ``tests/test_de_vs_scipy.py``: the port's DE follows scipy's
default configuration (best1bin, latin hypercube, dithered mutation,
binomial crossover, the same convergence test) with its own random stream,
so the two are held to the quality they reach on one GR4J
parameter-recovery problem, not to their trajectories.  The port's
objective is the ``'scan'`` engine, batched over the population, and its
DE polishes with ``gradient_descent``; scipy evaluates the same objective
on its whole population at once (``vectorized=True``) and runs unpolished,
as in the JAX package's test.
"""

import numpy as np
import pytest
import torch

from rrmpg_tpu_torch.ops import run_gr4j
from rrmpg_tpu_torch.tools import differential_evolution

pytestmark = pytest.mark.slow

F64 = torch.float64
NAMES = ('x1', 'x2', 'x3', 'x4')


def test_de_matches_scipy_quality_on_gr4j_recovery():
    from scipy.optimize import differential_evolution as scipy_de

    rng = np.random.default_rng(42)
    T = 730
    prec = torch.as_tensor(rng.uniform(0, 12, T), dtype=F64)
    etp = torch.as_tensor(rng.uniform(0, 4, T), dtype=F64)
    truth = {'x1': 350.0, 'x2': 1.2, 'x3': 110.0, 'x4': 2.1}
    qobs = run_gr4j(prec, etp, 0.3, 0.3, {
        k: torch.tensor([v], dtype=F64) for k, v in truth.items()})[0][0]
    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]

    def objective(X):                       # (P, 4) -> (P,)
        params = {n: X[:, j] for j, n in enumerate(NAMES)}
        qsim = run_gr4j(prec, etp, 0.3, 0.3, params)[0]
        return ((qsim - qobs[None, :]) ** 2).mean(-1)

    ours = differential_evolution(objective, bounds, seed=0, maxiter=60,
                                  batched=True, polish=True, device='cpu',
                                  dtype=F64)

    def np_objective(x):                    # (4, S) -> (S,)
        with torch.no_grad():
            return objective(torch.as_tensor(np.asarray(x).T,
                                             dtype=F64)).numpy()

    sp = scipy_de(np_objective, bounds, seed=0, maxiter=60, tol=0.01,
                  polish=False, vectorized=True, updating='deferred')

    # Both should essentially recover the truth (MSE near zero) and land
    # within an order of magnitude of each other.
    assert ours.fun < 1e-2
    assert ours.fun < max(10 * sp.fun, 1e-2)
    # Parameter recovery within a few percent on the dominant stores.
    assert abs(ours.x[0] - truth['x1']) / truth['x1'] < 0.10
    assert abs(ours.x[2] - truth['x3']) / truth['x3'] < 0.10
