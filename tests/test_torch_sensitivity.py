"""PyTorch port, Sobol' indices and Morris screening against JAX (CPU,
float64).

``rrmpg_tpu_torch.tools.sensitivity`` takes
``rrmpg_tpu.tools.sensitivity``'s parameters in its order, then ``device``
and ``dtype``.  Both packages make the design on the host (scipy's
``qmc.Sobol``, numpy's ``default_rng``), so with the same ``seed`` they
evaluate the same points and must give the same result: every field of
``SobolResult`` and ``MorrisResult`` at ``rtol=1e-10`` on the Ishigami
function and on a GR4J MSE objective (the port's ``'scan'`` ops against
JAX's XLA ops).  Rows with a non-finite output (HBV-Edu members whose soil
store empties) are dropped as JAX drops them; chunking by ``batch_size``
gives what one call gives; the validation errors are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import gr4j as jax_gr4j
from rrmpg_tpu.ops import hbvedu as jax_hbv
from rrmpg_tpu.tools import sensitivity as jax_sens
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch.models import GR4J, HBVEdu
from rrmpg_tpu_torch.ops import run_gr4j, run_hbvedu
from rrmpg_tpu_torch.tools import (MorrisResult, SobolResult,
                                   morris_screening, sobol_indices)
from rrmpg_tpu_torch.tools import sensitivity
from rrmpg_tpu_torch.utils import mse

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
RTOL = 1e-10
A, B = 7.0, 0.1
ISHIGAMI_BOUNDS = [(-np.pi, np.pi)] * 3


def ishigami(x):
    return (torch.sin(x[0]) + A * torch.sin(x[1]) ** 2
            + B * x[2] ** 4 * torch.sin(x[0]))


def ishigami_batched(X):
    return (torch.sin(X[:, 0]) + A * torch.sin(X[:, 1]) ** 2
            + B * X[:, 2] ** 4 * torch.sin(X[:, 0]))


def jax_ishigami(x):
    return (jnp.sin(x[0]) + A * jnp.sin(x[1]) ** 2
            + B * x[2] ** 4 * jnp.sin(x[0]))


def _assert_same_result(got, want):
    assert type(got).__name__ == type(want).__name__
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, (tuple, int)) or w is None:
            assert g == w, field
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-14,
                                       err_msg=field)


@pytest.mark.parametrize("n,seed,bootstrap", [(256, 5, 0), (512, 7, 30)])
def test_sobol_ishigami_matches_jax(n, seed, bootstrap):
    got = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=n, seed=seed,
                        bootstrap=bootstrap, names=('a', 'b', 'c'), **CPU)
    want = jax_sens.sobol_indices(jax_ishigami, ISHIGAMI_BOUNDS, n=n,
                                  seed=seed, bootstrap=bootstrap,
                                  names=('a', 'b', 'c'))
    assert isinstance(got, SobolResult)
    _assert_same_result(got, want)


@pytest.mark.parametrize("R,levels,seed,bootstrap",
                         [(16, 4, 1, 0), (64, 6, 4, 50)])
def test_morris_ishigami_matches_jax(R, levels, seed, bootstrap):
    got = morris_screening(ishigami, ISHIGAMI_BOUNDS, num_trajectories=R,
                           num_levels=levels, seed=seed, bootstrap=bootstrap,
                           **CPU)
    want = jax_sens.morris_screening(jax_ishigami, ISHIGAMI_BOUNDS,
                                     num_trajectories=R, num_levels=levels,
                                     seed=seed, bootstrap=bootstrap)
    assert isinstance(got, MorrisResult)
    _assert_same_result(got, want)


def test_sobol_matches_analytic_ishigami():
    res = sobol_indices(ishigami_batched, ISHIGAMI_BOUNDS, n=2048, seed=7,
                        batched=True, bootstrap=0, **CPU)
    v1 = 0.5 * (1 + B * np.pi ** 4 / 5) ** 2
    v2 = A ** 2 / 8
    v13 = B ** 2 * np.pi ** 8 * (1 / 18 - 1 / 50)
    v = v1 + v2 + v13
    np.testing.assert_allclose(res.s1, [v1 / v, v2 / v, 0.0], atol=0.03)
    np.testing.assert_allclose(res.st, [(v1 + v13) / v, v2 / v, v13 / v],
                               atol=0.03)
    assert res.n_used == res.n == 2048 and res.nfev == 2048 * 5


def _gr4j_case(T=150):
    rng = np.random.default_rng(0)
    prec, etp = rng.uniform(0, 15, T), rng.uniform(0, 4, T)
    qobs = GR4J(params={'x1': 400.0, 'x2': 1.0, 'x3': 100.0, 'x4': 1.5},
                **CPU).simulate(prec, etp)[:, 0].numpy()
    return prec, etp, qobs


def _gr4j_objectives(prec, etp, qobs):
    t_prec, t_etp, t_qobs = (torch.tensor(a) for a in (prec, etp, qobs))

    def port(X):
        params = {k: X[:, j] for j, k in enumerate(GR4J._param_list)}
        return mse(t_qobs[None], run_gr4j(t_prec, t_etp, 0.0, 0.0,
                                          params)[0])

    def xla(x):
        params = {k: x[j] for j, k in enumerate(GR4J._param_list)}
        qsim, _, _ = jax_gr4j.run_gr4j(jnp.asarray(prec), jnp.asarray(etp),
                                       0.0, 0.0, params)
        return jax_metrics.mse(jnp.asarray(qobs), qsim)

    return port, xla


def test_gr4j_mse_sobol_and_morris_match_jax():
    port, xla = _gr4j_objectives(*_gr4j_case())
    bounds = [GR4J._default_bounds[p] for p in GR4J._param_list]
    names = tuple(GR4J._param_list)
    _assert_same_result(
        sobol_indices(port, bounds, n=64, seed=1, batched=True,
                      bootstrap=20, names=names, **CPU),
        jax_sens.sobol_indices(xla, bounds, n=64, seed=1, bootstrap=20,
                               names=names))
    got = morris_screening(port, bounds, num_trajectories=16, seed=0,
                           batched=True, bootstrap=20, names=names, **CPU)
    _assert_same_result(got, jax_sens.morris_screening(
        xla, bounds, num_trajectories=16, seed=0, bootstrap=20,
        names=names))
    assert (got.mu_star > 0).all()


def _hbv_case(T=120):
    rng = np.random.default_rng(4)
    forcing = (rng.uniform(-5, 20, T), rng.uniform(0, 10, T),
               rng.integers(0, 12, T), rng.uniform(1, 4, 12),
               rng.uniform(0, 15, 12))
    return forcing, rng.uniform(0.1, 3, T)


def test_nonfinite_rows_dropped_as_jax_drops_them():
    """HBV-Edu's field capacity down to 1 empties the soil store of some
    members: their MSE is NaN, and both packages drop the same rows."""
    forcing, qobs = _hbv_case()
    names = HBVEdu._param_list
    bounds = [(1.0, 200.0) if p == 'FC' else HBVEdu._default_bounds[p]
              for p in names]
    t_forcing = [torch.tensor(a) for a in forcing]
    t_qobs = torch.tensor(qobs)

    def port(X):
        params = {k: X[:, j] for j, k in enumerate(names)}
        q = run_hbvedu(*t_forcing, 0.0, 100.0, 0.0, 0.0, params)[0]
        return mse(t_qobs[None], q)

    def xla(x):
        params = {k: x[j] for j, k in enumerate(names)}
        q = jax_hbv.run_hbvedu(*(jnp.asarray(a) for a in forcing), 0.0,
                               100.0, 0.0, 0.0, params)[0]
        return jax_metrics.mse(jnp.asarray(qobs), q)

    got = sobol_indices(port, bounds, n=64, seed=3, batched=True,
                        bootstrap=0, **CPU)
    want = jax_sens.sobol_indices(xla, bounds, n=64, seed=3, bootstrap=0)
    assert 8 <= got.n_used < 64
    _assert_same_result(got, want)
    got = morris_screening(port, bounds, num_trajectories=12, seed=3,
                           batched=True, bootstrap=0, **CPU)
    want = jax_sens.morris_screening(xla, bounds, num_trajectories=12,
                                     seed=3, bootstrap=0)
    assert (got.n_effects < 12).any()
    _assert_same_result(got, want)


@pytest.mark.parametrize("batch_size", [100, 7])
def test_batch_size_chunking_identical(batch_size):
    r1 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                       bootstrap=0, **CPU)
    r2 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                       bootstrap=0, batch_size=batch_size, **CPU)
    np.testing.assert_array_equal(r1.s1, r2.s1)
    np.testing.assert_array_equal(r1.st, r2.st)
    m1 = morris_screening(ishigami_batched, ISHIGAMI_BOUNDS,
                          num_trajectories=16, seed=2, bootstrap=0,
                          batched=True, **CPU)
    m2 = morris_screening(ishigami_batched, ISHIGAMI_BOUNDS,
                          num_trajectories=16, seed=2, bootstrap=0,
                          batched=True, batch_size=batch_size, **CPU)
    np.testing.assert_array_equal(m1.mu_star, m2.mu_star)


def test_key_draws_the_seed():
    key = torch.Generator().manual_seed(9)
    seed = int(torch.randint(0, 2**31 - 1, (),
                             generator=torch.Generator().manual_seed(9)))
    r1 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, key=key,
                       bootstrap=0, **CPU)
    r2 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, seed=seed,
                       bootstrap=0, **CPU)
    np.testing.assert_array_equal(r1.s1, r2.s1)
    with pytest.raises(TypeError, match="torch.Generator"):
        morris_screening(ishigami, ISHIGAMI_BOUNDS,
                         key=jax.random.PRNGKey(0), **CPU)


def test_validation_errors_match_jax():
    with pytest.raises(ValueError, match="finite"):
        sobol_indices(lambda x: torch.nan * x[0], ISHIGAMI_BOUNDS, n=64,
                      seed=0, bootstrap=0, **CPU)
    with pytest.raises(ValueError, match="names"):
        sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, names=('a',), **CPU)
    with pytest.raises(ValueError, match="even"):
        morris_screening(ishigami, ISHIGAMI_BOUNDS, num_levels=3, **CPU)
    with pytest.raises(ValueError, match="elementary effects"):
        morris_screening(lambda x: torch.nan * x[0], [(0, 1), (0, 1)],
                         num_trajectories=8, seed=0, bootstrap=0, **CPU)
    with pytest.raises(NotImplementedError, match="item 9"):
        sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, mesh=object(), **CPU)


def test_runs_on_the_card_by_default(monkeypatch):
    seen = []
    monkeypatch.setattr(sensitivity, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    morris_screening(ishigami, ISHIGAMI_BOUNDS, num_trajectories=4,
                     bootstrap=0, dtype=F64)
    assert seen == ["cuda"]


@pytest.mark.slow
def test_fused_objective_matches_scan_objective():
    """The fused GR4J MSE (batched=True; its plain version on the CPU)
    plugs into both entry points and matches the 'scan' objective."""
    from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused

    prec, etp, qobs = _gr4j_case(128)
    port, _ = _gr4j_objectives(prec, etp, qobs)
    t = [torch.tensor(a) for a in (prec, etp, qobs)]

    def fused(X):
        params = {k: X[:, j].contiguous()
                  for j, k in enumerate(GR4J._param_list)}
        return gr4j_ensemble_mse_fused(*t, 0.0, 0.0, params)

    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
    r_fused = sobol_indices(fused, bounds, n=64, seed=1, batched=True,
                            bootstrap=0, **CPU)
    r_scan = sobol_indices(port, bounds, n=64, seed=1, batched=True,
                           bootstrap=0, **CPU)
    np.testing.assert_allclose(r_fused.s1, r_scan.s1, atol=1e-8)
    np.testing.assert_allclose(r_fused.st, r_scan.st, atol=1e-8)
