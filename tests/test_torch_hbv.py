"""PyTorch port, the HBV-Edu slice against the JAX package (CPU, float64).

The same numpy inputs go through ``rrmpg_tpu`` and ``rrmpg_tpu_torch``:

* ops (``run_hbvedu(return_final=True)``, ``run_hbvedu_warm``) against
  ``rrmpg_tpu.ops.hbvedu``, ``rtol=1e-10``;
* the fused kernels' module (on CPU tensors the wrappers run the plain
  versions, written with the kernel's reciprocal multiplies) against the
  Pallas kernels in interpret mode, ``rtol=1e-9``: MSE, statistics, with
  and without gaps, trajectories, and one member driven to NaN, compared
  NaN-aware;
* the fused engine against the ``'scan'`` engine, ``rtol=1e-8``: a multiply
  by ``1/FC`` against a division, amplified by ``Beta`` up to 7 per step;
* ``HBVEdu`` (both engines, validation errors, the MATLAB golden, ``fit``)
  and ``monte_carlo`` against the JAX classes.  DE trajectories cannot
  match (JAX and torch draw different random numbers), so calibration is
  checked through the objective at JAX's optimum.

Every model is built with ``device='cpu'``; the kernels themselves are
tested on the card in ``tests/test_torch_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.ops import hbvedu as jax_hbv
from rrmpg_tpu.ops.pallas_hbv import (hbv_ensemble_mse_pallas,
                                      hbv_simulate_pallas)
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch.interop import params_from_numpy
from rrmpg_tpu_torch.models import HBVEdu
from rrmpg_tpu_torch.ops import fused_hbv, hbvedu
from rrmpg_tpu_torch.ops._launch import LAUNCHES, reset_launches
from rrmpg_tpu_torch.tools import monte_carlo

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
F64 = torch.float64
OPS_TOL = dict(rtol=1e-10, atol=1e-12)
KERNEL_TOL = dict(rtol=1e-9, atol=1e-12)
ENGINE_TOL = dict(rtol=1e-8, atol=1e-12)
INITS = (0.0, 100.0, 3.0, 10.0)
INIT_KW = dict(snow_init=0.0, soil_init=100.0, s1_init=3.0, s2_init=10.0)
LOSSES = ('mse', 'rmse', 'nse', 'kge')
NAMES = HBVEdu._param_list


def _inputs(T, N, seed=0, gaps=False, n_dry=0):
    """Forcing with 0-based months, qobs and (N,) parameter arrays; the
    first ``n_dry`` members get a field capacity that empties the soil
    store, so their discharge goes NaN."""
    rng = np.random.default_rng(seed)
    forcing = (rng.uniform(-10, 22, T), rng.uniform(0, 15, T),
               rng.integers(0, 12, T), rng.uniform(0.5, 4, 12),
               rng.uniform(-5, 15, 12))
    qobs = rng.uniform(0, 4, T)
    if gaps:
        qobs[::7] = np.nan
        qobs[20:35] = np.nan
    params = {k: rng.uniform(lo, hi, N)
              for k, (lo, hi) in HBVEdu._default_bounds.items()}
    params['FC'][:n_dry] = 2.0
    return forcing, qobs, params


def _tensors(forcing):
    temp, prec, month, pe_m, t_m = forcing
    return (torch.tensor(temp), torch.tensor(prec), torch.tensor(month),
            torch.tensor(pe_m), torch.tensor(t_m))


def _p64(params):
    return params_from_numpy(params, device='cpu', dtype=F64)


def _model(**kw):
    return HBVEdu(device='cpu', dtype=F64, **kw)


def _class_forcing(T, seed=0):
    rng = np.random.default_rng(seed)
    return dict(temp=rng.uniform(-5, 20, T), prec=rng.uniform(0, 10, T),
                month=rng.integers(1, 13, T), PE_m=rng.uniform(1, 4, 12),
                T_m=rng.uniform(0, 15, 12))


def _assert_close_nan_aware(got, want, n_nan_min=0, **tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).sum() >= n_nan_min
    np.testing.assert_allclose(got, want, **tol)      # NaN == NaN here


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_ops_match_jax_with_final_state():
    forcing, _, params = _inputs(250, 7, seed=1)
    want = jax.vmap(lambda p: jax_hbv.run_hbvedu(
        *forcing, *INITS, p, return_final=True))(
            {k: jnp.asarray(v) for k, v in params.items()})
    got = hbvedu.run_hbvedu(*_tensors(forcing), *INITS, _p64(params),
                            return_final=True)
    assert len(got) == 6 and got[0].shape == (7, 250)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL)
    for g, w in zip(got[5], want[5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL)
    assert (got[0][:, 0] == 0).all() and (got[2][:, 0] == 100.0).all()


def test_warm_matches_jax_and_chains():
    forcing, _, params = _inputs(200, 5, seed=2)
    temp, prec, month, pe_m, t_m = forcing
    state = (1.0, 120.0, 2.0, 8.0)
    want = jax.vmap(lambda p: jax_hbv.run_hbvedu_warm(*forcing, state, p))(
        {k: jnp.asarray(v) for k, v in params.items()})
    p64 = _p64(params)
    got = hbvedu.run_hbvedu_warm(*_tensors(forcing), state, p64)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL)
    # A cold start split anywhere and continued warm is the unbroken run.
    whole = hbvedu.run_hbvedu(*_tensors(forcing), *INITS, p64)
    first = hbvedu.run_hbvedu(
        *_tensors((temp[:80], prec[:80], month[:80], pe_m, t_m)), *INITS,
        p64, return_final=True)
    rest = hbvedu.run_hbvedu_warm(
        *_tensors((temp[80:], prec[80:], month[80:], pe_m, t_m)), first[5],
        p64)
    np.testing.assert_allclose(torch.cat([first[0], rest[0]], 1).numpy(),
                               whole[0].numpy(), **OPS_TOL)


# ---------------------------------------------------------------------------
# kernel module (plain versions on CPU) vs Pallas interpret
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_objective_plain_matches_pallas_interpret(stats, masked):
    forcing, qobs, params = _inputs(400, 20, seed=3, gaps=masked, n_dry=1)
    want = hbv_ensemble_mse_pallas(*forcing, qobs, *INITS, params,
                                   t_tile=128, interpret=True, stats=stats,
                                   masked=masked)
    reset_launches()
    got = fused_hbv.hbv_ensemble_mse_fused(
        *_tensors(forcing), torch.tensor(qobs), *INITS, _p64(params),
        stats=stats, masked=masked)
    assert not any(LAUNCHES.values())     # CPU tensors: the plain version
    assert got.shape == ((4, 20) if stats else (20,))
    _assert_close_nan_aware(got.numpy(), want, n_nan_min=1, **KERNEL_TOL)
    assert np.isfinite(got.numpy()[..., 1:]).all()


def test_traj_plain_matches_pallas_interpret():
    forcing, _, params = _inputs(400, 20, seed=4, n_dry=1)
    want = hbv_simulate_pallas(*forcing, *INITS, params, t_tile=128,
                               interpret=True)
    got = fused_hbv.hbv_simulate_fused(*_tensors(forcing), *INITS,
                                       _p64(params))
    assert got.shape == (20, 400)
    _assert_close_nan_aware(got.numpy(), want, n_nan_min=1, **KERNEL_TOL)


def test_fused_plain_matches_scan_engine():
    """The reciprocal multiplies of the fused step against the divisions
    of the scan engine, NaN member included."""
    forcing, _, params = _inputs(400, 20, seed=5, n_dry=1)
    p64 = _p64(params)
    want = hbvedu.run_hbvedu(*_tensors(forcing), *INITS, p64)[0]
    got = fused_hbv.hbv_simulate_fused(*_tensors(forcing), *INITS, p64)
    _assert_close_nan_aware(got.numpy(), want.numpy(), n_nan_min=1,
                            **ENGINE_TOL)


def test_kernel_module_input_checks():
    forcing, qobs, params = _inputs(30, 4)
    tensors, p64 = _tensors(forcing), _p64(params)
    with pytest.raises(ValueError, match="no finite value"):
        fused_hbv.hbv_ensemble_mse_fused(
            *tensors, torch.full((30,), torch.nan, dtype=F64), *INITS, p64,
            masked=True)
    # state= enters warm: every step advances the stores (rtol 1e-12: the
    # plain steps of the warm scan, summed in time order).
    got = fused_hbv.hbv_ensemble_mse_fused(*tensors, torch.tensor(qobs),
                                           0.0, 0.0, 0.0, 0.0, p64,
                                           state=INITS)
    qsim = hbvedu.run_hbvedu_warm(*tensors, INITS, p64)[0]
    want = ((qsim - torch.tensor(qobs)) ** 2).mean(dim=1)
    _assert_close_nan_aware(got.numpy(), want.numpy(), rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError, match="one device"):
        fused_hbv.hbv_simulate_fused(*tensors, *INITS,
                                     {k: v.float() for k, v in p64.items()})
    with pytest.raises(ValueError, match=r"\(T,\)"):
        fused_hbv.hbv_ensemble_mse_fused(*tensors, torch.tensor(qobs[:-1]),
                                         *INITS, p64)
    assert fused_hbv.pack_params(p64, *INITS).shape == (17, 4)


# ---------------------------------------------------------------------------
# class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_simulate_matches_jax(engine):
    forcing = _class_forcing(200, seed=6)
    np.random.seed(7)
    params = jax_models.HBVEdu().get_random_params(num=8)
    want = jax_models.HBVEdu().simulate(params=params, **forcing, **INIT_KW)
    got = _model().simulate(params=params, engine=engine, **forcing,
                            **INIT_KW)
    assert got.shape == want.shape == (200, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENGINE_TOL)
    assert params_from_numpy(params, device='cpu', dtype=F64).keys() == set(
        NAMES)


def test_simulate_storage_and_errors():
    forcing = _class_forcing(40)
    model = _model()
    want = jax_models.HBVEdu(params=model.get_params()).simulate(
        **forcing, **INIT_KW, return_storage=True)
    got = model.simulate(**forcing, **INIT_KW, return_storage=True)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == (40, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL)
    with pytest.raises(ValueError, match="discharge only"):
        model.simulate(**forcing, return_storage=True, engine='fused')
    with pytest.raises(ValueError, match="engine"):
        model.simulate(**forcing, engine='pallas')
    with pytest.raises(ValueError, match="non-negative"):
        model.simulate(**dict(forcing, prec=-forcing['prec']))
    with pytest.raises(ValueError, match="Month"):
        model.simulate(**dict(forcing, month=forcing['month'] + 1))
    with pytest.raises(RuntimeError, match="12"):
        model.simulate(**dict(forcing, PE_m=forcing['PE_m'][:11]))
    with pytest.raises(RuntimeError, match="matching lengths"):
        model.simulate(**dict(forcing, temp=forcing['temp'][:-1]))
    with pytest.raises(TypeError, match="return_storage"):
        model.simulate(**forcing, return_storage=1)
    qsim, state = model.simulate(**forcing, return_final_state=True)
    assert torch.equal(qsim, model.simulate(**forcing))
    assert type(state).__name__ == "HBVEduState" and state.soil.shape == (1,)
    with pytest.raises(TypeError, match="must be a HBVEduState"):
        model.fit(forcing['prec'], **forcing, initial_state=object())
    with pytest.raises(ValueError, match="not both"):
        model.simulate(**forcing, soil_init=100., initial_state=state)


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_golden_matlab_trajectory(engine):
    daily = pd.read_csv(os.path.join(DATA_DIR, 'hbv_daily_inputs.txt'),
                        sep='\t', names=['date', 'month', 'temp', 'prec'])
    monthly = pd.read_csv(os.path.join(DATA_DIR, 'hbv_monthly_inputs.txt'),
                          sep=' ', names=['temp', 'not_needed', 'evap'])
    qsim_matlab = pd.read_csv(os.path.join(DATA_DIR, 'hbv_qsim.csv'),
                              header=None, names=['qsim'])
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    qsim = _model(params=params).simulate(
        temp=daily.temp, prec=daily.prec, month=daily.month,
        PE_m=monthly.evap, T_m=monthly.temp, engine=engine, **INIT_KW)
    qsim = (qsim.numpy().ravel() * 410 * 1000) / (24 * 60 * 60)
    assert np.allclose(qsim, qsim_matlab.qsim)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("gaps", [False, True])
def test_monte_carlo_matches_jax(engine, gaps):
    """Same np.random.seed -> same ensemble; the fused statistics (or the
    scan engine's masked metrics) vs JAX's XLA metrics, rtol=1e-8 (the
    reciprocal multiplies, then differences of means in NSE/KGE)."""
    forcing = _class_forcing(150, seed=8)
    qobs = np.random.default_rng(8).uniform(0.2, 5, 150)
    if gaps:
        qobs[::9] = np.nan
    metric_names = ('mse', 'rmse', 'nse', 'kge')
    np.random.seed(11)
    want = jax_monte_carlo(jax_models.HBVEdu(), num=48, qobs=qobs,
                           metrics=metric_names, return_qsim=False,
                           **forcing, **INIT_KW)
    np.random.seed(11)
    got = monte_carlo(_model(), num=48, qobs=qobs, metrics=metric_names,
                      return_qsim=False, engine=engine, **forcing, **INIT_KW)
    np.testing.assert_array_equal(got['params'], want['params'])
    for m in metric_names:
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-8,
                                   err_msg=m)


def _objective(model, qobs, forcing, loss_metric, engine):
    tensors = model._forcing_tensors(**forcing)
    return model._batch_objective(torch.tensor(qobs), tensors, INITS,
                                  loss_metric, engine)


def test_fit_objective_at_jax_optimum():
    forcing = _class_forcing(120, seed=9)
    qobs = np.random.default_rng(9).uniform(0.2, 5, 120)
    jres = jax_models.HBVEdu().fit(qobs, **forcing, **INIT_KW, seed=0,
                                   maxiter=2)
    x = torch.tensor(np.asarray(jres.x))[None, :]
    for engine in ('fused', 'scan'):
        objective = _objective(_model(), qobs, forcing, 'mse', engine)
        assert objective(x).item() == pytest.approx(jres.fun, rel=1e-8)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("loss_metric", LOSSES)
def test_fit_every_loss(loss_metric, engine):
    """``fit`` gives a finite loss inside the bounds, and its objective
    equals JAX's calibration loss on the same candidates, gaps included."""
    forcing = _class_forcing(120, seed=10)
    qobs = np.random.default_rng(10).uniform(0.2, 5, 120)
    qobs[::8] = np.nan
    model = _model()
    res = model.fit(qobs, **forcing, **INIT_KW, loss_metric=loss_metric,
                    engine=engine, seed=0, maxiter=2)
    assert np.isfinite(res.fun) and res.nit <= 2
    assert res.population.shape == (165, 11)
    for (lo, hi), v in zip(HBVEdu._default_bounds.values(), res.x):
        assert lo <= v <= hi

    np.random.seed(3)
    params = jax_models.HBVEdu().get_random_params(num=5)
    qsim = np.asarray(jax_models.HBVEdu().simulate(params=params, **forcing,
                                                   **INIT_KW))
    loss = jax_metrics.calibration_loss(loss_metric)
    want = np.array([float(loss(qobs, qsim[:, i])) for i in range(5)])
    X = torch.tensor(np.stack([params[n] for n in NAMES], 1))
    got = _objective(model, qobs, forcing, loss_metric, engine)(X)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


def test_fit_all_nan_qobs_raises():
    forcing = _class_forcing(30)
    with pytest.raises(ValueError, match="no finite value"):
        _model().fit(np.full(30, np.nan), **forcing, engine='fused',
                     maxiter=1)
