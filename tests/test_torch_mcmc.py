"""PyTorch port, DE-MC sampling against JAX (CPU, float64).

``rrmpg_tpu_torch.tools.mcmc.demc_sample`` takes
``rrmpg_tpu.tools.mcmc.demc_sample``'s parameters in its order, then
``device`` and ``dtype``.  ``_split_r_hat`` equals JAX's at ``rtol=1e-12``
(the same numpy on the same draws).  The random streams differ
(``torch.Generator`` against ``jax.random``), so the sampler is held to the
JAX tests' tolerances on targets with known posteriors: a correlated
Gaussian's moments, the uniform box as the prior's support, rejection of
a non-finite log-probability, and the shapes of thinning and burn-in.
"""

import jax
import numpy as np
import pytest
import torch

from rrmpg_tpu.tools import mcmc as jax_mcmc
from rrmpg_tpu_torch.tools import MCMCResult, demc_sample
from rrmpg_tpu_torch.tools import mcmc

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)


def _gauss(x):
    return -0.5 * torch.sum(x ** 2)


@pytest.mark.parametrize("shape,seed", [((200, 8, 3), 0), ((31, 6, 2), 1),
                                        ((3, 4, 2), 2)])
def test_split_r_hat_matches_jax(shape, seed):
    draws = np.random.default_rng(seed).normal(size=shape)
    draws[:, 0] += np.linspace(0, 2, shape[0])[:, None]   # a drifting chain
    np.testing.assert_allclose(mcmc._split_r_hat(draws),
                               jax_mcmc._split_r_hat(draws), rtol=1e-12)


def test_recovers_correlated_gaussian():
    mean = torch.tensor([1.0, -0.5], dtype=F64)
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))

    def lp(x):
        d = x - mean
        return -0.5 * d @ prec @ d

    res = demc_sample(lp, [(-10, 10), (-10, 10)], num_chains=16,
                      num_steps=4000, seed=0, **CPU)
    assert isinstance(res, MCMCResult)
    flat = res.flat()
    np.testing.assert_allclose(flat.mean(0), [1.0, -0.5], atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)
    assert 0.15 < res.acceptance_rate < 0.6
    assert (res.r_hat < 1.05).all()
    np.testing.assert_allclose(res.x_map, [1.0, -0.5], atol=0.3)


def test_deterministic_batched_and_key():
    r1 = demc_sample(_gauss, [(-5, 5)] * 3, num_steps=200, seed=7, **CPU)
    r2 = demc_sample(_gauss, [(-5, 5)] * 3, num_steps=200, seed=7, **CPU)
    np.testing.assert_array_equal(r1.samples, r2.samples)
    r3 = demc_sample(lambda X: -0.5 * torch.sum(X ** 2, dim=1),
                     [(-5, 5)] * 3, num_steps=200, seed=7, batched=True,
                     **CPU)
    np.testing.assert_allclose(r3.samples, r1.samples, rtol=1e-12)
    r4 = demc_sample(_gauss, [(-5, 5)] * 3, num_steps=200,
                     key=torch.Generator().manual_seed(7), **CPU)
    np.testing.assert_array_equal(r4.samples, r1.samples)


def test_bounds_are_prior_support():
    res = demc_sample(lambda x: torch.zeros((), dtype=x.dtype),
                      [(2.0, 3.0), (-1.0, 0.0)], num_chains=16,
                      num_steps=2000, seed=1, **CPU)
    flat = res.flat()
    assert flat[:, 0].min() >= 2.0 and flat[:, 0].max() <= 3.0
    assert flat[:, 1].min() >= -1.0 and flat[:, 1].max() <= 0.0
    np.testing.assert_allclose(flat.mean(0), [2.5, -0.5], atol=0.08)


def test_nonfinite_logprob_rejected():
    def lp(x):
        return torch.where(x[0] > 0.5, torch.nan, -0.5 * x[0] ** 2)

    res = demc_sample(lp, [(-2.0, 2.0)], num_chains=8, num_steps=500,
                      seed=3, **CPU)
    assert np.isfinite(res.log_probs).all()
    assert (res.flat()[:, 0] <= 0.5).all()


def test_thinning_and_burn_in_shapes():
    res = demc_sample(_gauss, [(-5, 5)] * 2, num_chains=8, num_steps=1000,
                      burn_in=0.4, thin=5, seed=0, **CPU)
    assert res.samples.shape == (120, 8, 2)
    assert res.log_probs.shape == (120, 8)


def test_segments_longer_than_one_copy():
    """1100 steps run as segments of 512, 512 and 76: the draws of every
    step come back, in order."""
    res = demc_sample(_gauss, [(-5, 5)] * 2, num_chains=4, num_steps=1100,
                      burn_in=0.0, seed=4, **CPU)
    assert res.samples.shape == (1100, 4, 2)
    moved = np.abs(np.diff(res.samples, axis=0)).sum(axis=(1, 2)) > 0
    assert moved[-50:].any() and moved[500:530].any()


def test_validation():
    with pytest.raises(ValueError, match="burn_in"):
        demc_sample(_gauss, [(0, 1)], burn_in=1.0, **CPU)
    with pytest.raises(ValueError, match="thin"):
        demc_sample(_gauss, [(0, 1)], thin=0, **CPU)
    with pytest.raises(ValueError, match="chains"):
        demc_sample(_gauss, [(0, 1)], num_chains=2, **CPU)
    res = demc_sample(_gauss, [(0, 1)], num_chains=5, num_steps=20, seed=0,
                      **CPU)
    assert res.samples.shape[1] == 6
    # A mesh runs (tests/test_torch_parallel.py); a non-mesh object is
    # refused by type.
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        demc_sample(_gauss, [(0, 1)], mesh=object(), **CPU)
    with pytest.raises(TypeError, match="torch.Generator"):
        demc_sample(_gauss, [(0, 1)], key=jax.random.PRNGKey(0), **CPU)


def test_runs_on_the_card_by_default(monkeypatch):
    seen = []
    monkeypatch.setattr(mcmc, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    demc_sample(_gauss, [(0, 1)], num_steps=2, dtype=F64)
    assert seen == ["cuda"]


@pytest.mark.slow
def test_gr4j_posterior_concentrates_on_truth():
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused, run_gr4j

    rng = np.random.default_rng(0)
    T = 365
    prec = torch.tensor(rng.gamma(0.8, 6.0, T))
    etp = torch.tensor(rng.uniform(1, 4, T))
    truth = np.array([350.0, 1.2, 80.0, 1.8])
    q_true = run_gr4j(prec, etp, 0.0, 0.0, {
        k: torch.tensor([v]) for k, v in zip(GR4J._param_list, truth)})[0][0]
    sigma = 0.05
    qobs = q_true + torch.tensor(rng.normal(0, sigma, T))

    def log_prob(X):
        params = {k: X[:, j].contiguous()
                  for j, k in enumerate(GR4J._param_list)}
        mse = gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0, params)
        return -0.5 * T * mse / sigma ** 2

    bounds = [GR4J._default_bounds[p] for p in GR4J._param_list]
    res = demc_sample(log_prob, bounds, num_chains=16, num_steps=3000,
                      seed=0, batched=True, **CPU)
    flat = res.flat()
    lo, hi = np.percentile(flat, [2.5, 97.5], axis=0)
    assert ((truth >= lo) & (truth <= hi)).all()
    assert abs(flat[:, 1].mean() - truth[1]) < 0.2
    np.testing.assert_allclose(res.x_map[1], truth[1], atol=0.2)
