"""PyTorch port, SCE-UA against JAX (CPU, float64).

``rrmpg_tpu_torch.tools.sce.sce_ua`` takes ``rrmpg_tpu.tools.sce.sce_ua``'s
parameters in its order, then ``device`` and ``dtype``.  Its helpers
``_safe``, ``_sort_complexes`` and ``_shuffle`` equal JAX's bit for bit on
the same arrays, NaN and tied energies included (both sort stably).  The
random streams differ (``torch.Generator`` against ``jax.random``), so the
optimizer is held to what the JAX tests ask of JAX's: convergence on
Rosenbrock and Ackley, ``nfev = p m + nit beta 3 p`` exactly, the same run
under the same seed, quarantine of non-finite energies, and the recovery
of a GR4J truth by ``fit(method='sce')`` to ``fun < 1e-2``.  Every class
takes ``fit(method='sce')``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.tools import sce as jax_sce
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.tools import minimize, sce_ua
from rrmpg_tpu_torch.tools import sce

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
BOUNDS2 = [(-5.0, 10.0), (-5.0, 10.0)]


def rosen(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def rosen_batch(X):
    return (1.0 - X[:, 0]) ** 2 + 100.0 * (X[:, 1] - X[:, 0] ** 2) ** 2


def ackley(x):
    a, b, c = 20.0, 0.2, 2.0 * np.pi
    return (-a * torch.exp(-b * torch.sqrt(torch.mean(x ** 2)))
            - torch.exp(torch.mean(torch.cos(c * x))) + a + np.e)


def _energies(p, m, seed):
    """(p, m) energies with NaN, inf and ties, and a (p, m, 3) population."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 4, (p, m)).astype(np.float64)   # many ties
    e[0, 1] = np.nan
    e[1, 0] = np.inf
    e[-1, -1] = -np.inf
    e[p // 2, m // 2] = np.nan
    return rng.uniform(0, 1, (p, m, 3)), e


def _pair(a):
    return torch.tensor(a), jnp.asarray(a)


def test_safe_matches_jax():
    _, e = _energies(4, 9, 0)
    t, j = _pair(e)
    np.testing.assert_array_equal(sce._safe(t).numpy(),
                                  np.asarray(jax_sce._safe(j)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_complexes_matches_jax(seed):
    pop, e = _energies(4, 9, seed)
    got = sce._sort_complexes(torch.tensor(pop), torch.tensor(e))
    want = jax_sce._sort_complexes(jnp.asarray(pop), jnp.asarray(e))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shuffle_matches_jax(seed):
    p, m = 4, 9
    pop, e = _energies(p, m, seed)
    got = sce._shuffle(torch.tensor(pop), torch.tensor(e), p, m, 3)
    want = jax_sce._shuffle(jnp.asarray(pop), jnp.asarray(e), p, m, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rosenbrock_converges():
    res = sce_ua(rosen, BOUNDS2, seed=0, maxiter=200, tol=0.0, peps=1e-7,
                 **CPU)
    assert res.success
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-4)
    assert res.fun < 1e-8


def test_multimodal_global_minimum():
    res = sce_ua(ackley, [(-32.8, 32.8)] * 2, seed=1, maxiter=150,
                 n_complexes=8, **CPU)
    np.testing.assert_allclose(res.x, [0.0, 0.0], atol=1e-3)
    assert res.fun < 1e-2


def test_nfev_accounting_exact():
    res = sce_ua(rosen, BOUNDS2, seed=0, maxiter=7, tol=0.0, peps=0.0,
                 **CPU)
    dim = 2
    p, m, beta = max(2, dim), 2 * dim + 1, 2 * dim + 1
    assert res.nit == 7
    assert res.nfev == p * m + res.nit * beta * 3 * p
    assert not res.success
    assert res.population.shape == (p * m, dim)


def test_deterministic_under_seed_and_key():
    r1 = sce_ua(rosen, BOUNDS2, seed=42, maxiter=20, **CPU)
    r2 = sce_ua(rosen, BOUNDS2, seed=42, maxiter=20, **CPU)
    np.testing.assert_array_equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.population, r2.population)
    assert r1.fun == r2.fun
    key = torch.Generator().manual_seed(42)
    r3 = sce_ua(rosen, BOUNDS2, key=key, maxiter=20, **CPU)
    np.testing.assert_array_equal(r3.population, r1.population)


def test_population_within_bounds():
    res = sce_ua(rosen, BOUNDS2, seed=3, maxiter=30, **CPU)
    assert (res.population >= -5.0 - 1e-12).all()
    assert (res.population <= 10.0 + 1e-12).all()


def test_batched_objective_is_the_same_run():
    res = sce_ua(rosen_batch, BOUNDS2, seed=0, maxiter=200, batched=True,
                 tol=0.0, peps=1e-7, **CPU)
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-4)
    ref = sce_ua(rosen, BOUNDS2, seed=0, maxiter=200, tol=0.0, peps=1e-7,
                 **CPU)
    np.testing.assert_array_equal(res.x, ref.x)


def test_nonfinite_quarantine():
    def guarded(x):
        return torch.where((x[0] < 0.0) | (x[1] < 0.0), torch.nan, rosen(x))

    res = sce_ua(guarded, BOUNDS2, seed=5, maxiter=100, **CPU)
    assert np.isfinite(res.fun)
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-2)


def test_minimize_dispatch():
    res = minimize(rosen, BOUNDS2, method="sce", seed=0, maxiter=50, **CPU)
    assert res.fun < 1e-3
    res_de = minimize(rosen, BOUNDS2, method="de", seed=0, maxiter=50,
                      **CPU)
    assert res_de.fun < 1e-3
    with pytest.raises(ValueError, match="method"):
        minimize(rosen, BOUNDS2, method="nelder-mead", **CPU)


def test_mesh_and_jax_key_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        sce_ua(rosen, BOUNDS2, mesh=object(), **CPU)
    with pytest.raises(TypeError, match="torch.Generator"):
        sce_ua(rosen, BOUNDS2, key=jax.random.PRNGKey(0), **CPU)


def test_runs_on_the_card_by_default(monkeypatch):
    seen = []
    monkeypatch.setattr(sce, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    sce_ua(rosen, BOUNDS2, maxiter=1, dtype=F64)
    assert seen == ["cuda"]


def _gr4j_truth(T=365):
    rng = np.random.default_rng(0)
    prec, etp = rng.uniform(0, 15, T), rng.uniform(0, 4, T)
    truth = {'x1': 350.0, 'x2': 1.2, 'x3': 80.0, 'x4': 1.8}
    qobs = models.GR4J(params=truth, **CPU).simulate(prec, etp)[:, 0]
    return prec, etp, qobs.numpy()


def test_gr4j_fit_method_sce():
    """fit(method='sce') recovers a synthetic truth to the quality JAX's
    test asks of JAX's fit(method='sce') (fun < 1e-2), on 150 of its 365
    days (the plain version's time loop is a Python loop)."""
    prec, etp, qobs = _gr4j_truth(150)
    res = models.GR4J(**CPU).fit(qobs, prec, etp, seed=0, method='sce',
                                 maxiter=60, n_complexes=6, engine='fused')
    assert res.fun < 1e-2
    assert res.nfev == 6 * 9 + res.nit * 9 * 3 * 6


def _class_inputs(name, T=60):
    rng = np.random.default_rng(2)
    if name == "GR4J":
        return (rng.uniform(0.1, 3, T), rng.uniform(0, 15, T),
                rng.uniform(0, 4, T)), {}
    if name == "ABCModel":
        return (rng.uniform(0.1, 3, T), rng.uniform(0, 15, T)), {}
    if name == "HBVEdu":
        return (rng.uniform(0.1, 3, T), rng.uniform(-5, 20, T),
                rng.uniform(0, 10, T), rng.integers(1, 13, T),
                rng.uniform(1, 4, 12), rng.uniform(0, 15, 12)), dict(
                    soil_init=100.0)
    mean_t = rng.uniform(-8, 10, T)
    met = (rng.gamma(0.8, 6.0, T), mean_t, mean_t - 3, mean_t + 3)
    kw = dict(met_station_height=495, altitudes=[550, 620, 700, 785, 920])
    if name == "Cemaneige":
        return (rng.uniform(0, 3, T), *met), kw
    etp = rng.uniform(0.5, 3, T)
    if name.endswith("Ice"):
        return (rng.uniform(0.1, 3, T), *met, etp,
                np.array([0.02, 0.04, 0.25, 0.51, 0.71])), kw
    return (rng.uniform(0.1, 3, T), *met, etp), kw


@pytest.mark.parametrize("name", ['GR4J', 'HBVEdu', 'ABCModel', 'Cemaneige',
                                  'CemaneigeGR4J', 'CemaneigeGR4JIce',
                                  'CemaneigeHystGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_every_class_fits_with_sce(name):
    args, kw = _class_inputs(name)
    model = getattr(models, name)(**CPU)
    res = model.fit(*args, **kw, seed=0, method='sce', maxiter=1)
    dim = len(model._param_list)
    p, m, beta = max(2, dim), 2 * dim + 1, 2 * dim + 1
    assert res.nfev == p * m + res.nit * beta * 3 * p
    assert np.isfinite(res.fun)
    lo = np.array([model._default_bounds[k][0] for k in model._param_list])
    hi = np.array([model._default_bounds[k][1] for k in model._param_list])
    assert ((res.x >= lo - 1e-9) & (res.x <= hi + 1e-9)).all()


def test_hbv_nan_members_quarantined():
    """HBV-Edu candidates whose soil store empties have NaN losses; SCE on
    the fused engine (its plain version here) never selects one."""
    args, kw = _class_inputs("HBVEdu", T=120)
    model = models.HBVEdu(**CPU)
    model._default_bounds = dict(model._default_bounds, FC=(1.0, 200.0))
    res = model.fit(*args, **kw, seed=0, method='sce', maxiter=3,
                    engine='fused')
    assert np.isfinite(res.fun)
    assert res.fun == np.nanmin(res.population_energies)


@pytest.mark.slow
def test_sce_with_fused_objective():
    """SCE-UA drives the fused GR4J MSE objective (batched=True; its plain
    version on the CPU) to the optimum region, as JAX's test asks of the
    Pallas kernel (fun < 0.5)."""
    from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused

    prec, etp, qobs = (torch.tensor(a) for a in _gr4j_truth(128))

    def fused(X):
        params = {k: X[:, j].contiguous()
                  for j, k in enumerate(('x1', 'x2', 'x3', 'x4'))}
        return gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0, params,
                                       num_uh1=3, num_uh2=7)

    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
    res = sce_ua(fused, bounds, seed=0, maxiter=30, batched=True,
                 n_complexes=4, **CPU)
    assert np.isfinite(res.fun)
    assert res.fun < 0.5
