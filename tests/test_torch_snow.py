"""PyTorch port, the snow slice against the JAX package (CPU, float64).

The five snow classes (``Cemaneige``, ``CemaneigeGR4J``,
``CemaneigeGR4JIce``, ``CemaneigeHystGR4J``, ``CemaneigeHystGR4JIce``) on
both engines, fed the same numpy inputs as ``rrmpg_tpu.models``:

* the four Excel goldens (``np.allclose``), through the ``'scan'`` engine
  and through the plain version of K9;
* ``simulate`` (discharge and storages, 5 layers and a single layer),
  ``monte_carlo(return_qsim=False)`` and the calibration objectives of
  ``fit`` and ``fit_Q_SCA`` against the JAX classes, ``rtol=1e-8`` (the
  fused step multiplies by ``1/Thacc`` and divides the layer sum where the
  XLA ops divide and take ``mean``; NSE/KGE then take differences of means);
* the validation errors of the met preprocessing: same type, same message;
* the pinned quirks (``sca_init`` inert), the port's decisions (an all-NaN
  record raises) and the features that wait (each names its queue item).

DE trajectories cannot match (JAX and torch draw different random numbers),
so calibration is checked through the objective: the losses ``fit`` reports
for its final population against JAX's loss of the same parameter sets.

Every model is built with ``device='cpu'``; the kernels themselves are
tested on the card in ``tests/test_torch_cuda.py``.
"""

import functools
import os

import numpy as np
import pandas as pd
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.tools import monte_carlo

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
ALTITUDES = [550, 620, 700, 785, 920]
FRAC_ICE = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
HYST_PARAMS = {"Thacc": 18.6, "Rsp": 0.22, "CTG": 0.78, "Kf": 4.02,
               "x1": 546, "x2": 0.53, "x3": 276, "x4": 1.32}
CLASSES = ['Cemaneige', 'CemaneigeGR4J', 'CemaneigeGR4JIce',
           'CemaneigeHystGR4J', 'CemaneigeHystGR4JIce']
HYST_CLASSES = CLASSES[3:]
ENGINES = ['scan', 'fused']


def _model(name, **kw):
    return getattr(models, name)(device='cpu', dtype=F64, **kw)


def _jax_model(name, **kw):
    return getattr(jax_models, name)(**kw)


def _forcing(name, T=160, seed=0, altitudes=ALTITUDES):
    """Keyword arguments of ``simulate`` for class ``name``."""
    rng = np.random.default_rng(seed)
    mean_t = rng.uniform(-9, 13, T)
    kw = dict(prec=rng.uniform(0, 14, T), mean_temp=mean_t,
              min_temp=mean_t - rng.uniform(0.5, 4, T),
              max_temp=mean_t + rng.uniform(0.5, 4, T),
              met_station_height=700, altitudes=altitudes,
              snow_pack_init=1.5, thermal_state_init=-0.5)
    if name != 'Cemaneige':
        kw.update(etp=rng.uniform(0, 3, T), s_init=0.4, r_init=0.3)
    if 'Ice' in name:
        kw['frac_ice'] = FRAC_ICE[:max(len(altitudes), 1)]
    return kw


def _ndsi(T, seed, gaps=False):
    rng = np.random.default_rng(seed)
    bands = [rng.uniform(0, 100, T) for _ in range(5)]
    if gaps:
        bands[1][rng.choice(T, T // 4, replace=False)] = np.nan
        bands[4][::9] = np.nan
    return {f'NDSI{i + 1}': b for i, b in enumerate(bands)}


def _random_params(name, num, seed):
    np.random.seed(seed)
    return _jax_model(name).get_random_params(num=num)


@functools.lru_cache(maxsize=None)
def _jax_simulate(name, num, seed, storage=False, single_layer=False):
    """JAX's simulation of ``num`` random parameter sets (cached: both
    engines of the port are compared with one JAX run)."""
    kw = _forcing(name, seed=seed,
                  altitudes=[] if single_layer else ALTITUDES)
    if storage:
        kw['return_storages' if name == 'Cemaneige'
           else 'return_storage'] = True
    return _jax_model(name).simulate(
        params=_random_params(name, num, seed), **kw)


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _read(name, **kw):
    return pd.read_csv(os.path.join(DATA_DIR, name), **kw)


def _golden(name, engine):
    """(simulated, Excel) series of one golden, with the settings of
    ``tests/test_models_golden.py``."""
    if name == 'Cemaneige':
        df = _read('cemaneige_validation_data.csv', sep=';')
        return _model(name, params={'CTG': 0.25, 'Kf': 3.74}).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp,
            met_station_height=495, altitudes=ALTITUDES,
            engine=engine), df.liquid_outflow
    if name == 'CemaneigeGR4J':
        params = {'CTG': 0.25, 'Kf': 3.74,
                  'x1': np.exp(5.25483021675164),
                  'x2': np.sinh(1.58209470624126),
                  'x3': np.exp(4.3853181982412),
                  'x4': np.exp(0.954786342674327) + 0.5}
        df = _read('cemaneigegr4j_validation_data.csv', sep=';', index_col=0)
        return _model(name, params=params).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
            met_station_height=495, altitudes=ALTITUDES, s_init=0.6,
            r_init=0.7, engine=engine), df.qsim
    if name == 'CemaneigeHystGR4J':
        df = _read('cemaneigehystgr4j_validation_data.csv', index_col=0)
        return _model(name, params=HYST_PARAMS).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
            met_station_height=700, altitudes=ALTITUDES, s_init=0.5,
            r_init=0.4, engine=engine), df.qsim
    df = _read('cemaneigehystgr4jice_validation_data.csv', index_col=0)
    return _model(name, params=dict(HYST_PARAMS, DDF=5)).simulate(
        df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
        FRAC_ICE, met_station_height=700, altitudes=ALTITUDES, s_init=0.5,
        r_init=0.4, sca_init=0.2, engine=engine), df.qsim


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ['Cemaneige', 'CemaneigeGR4J',
                                  'CemaneigeHystGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_golden_excel_trajectory(name, engine):
    qsim, excel = _golden(name, engine)
    assert qsim.shape == (len(excel), 1)
    assert np.allclose(qsim.numpy().ravel(), excel.to_numpy())


# ---------------------------------------------------------------------------
# simulate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", CLASSES)
def test_simulate_matches_jax(name, engine):
    want = _jax_simulate(name, 6, seed=1)
    got = _model(name).simulate(params=_random_params(name, 6, 1),
                                engine=engine, **_forcing(name, seed=1))
    assert got.shape == want.shape == (160, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,n_out", [
    ('Cemaneige', 3), ('CemaneigeGR4J', 5), ('CemaneigeGR4JIce', 6),
    ('CemaneigeHystGR4J', 7), ('CemaneigeHystGR4JIce', 9)])
def test_simulate_storages_match_jax(name, n_out):
    want = _jax_simulate(name, 3, seed=2, storage=True)
    key = 'return_storages' if name == 'Cemaneige' else 'return_storage'
    got = _model(name).simulate(params=_random_params(name, 3, 2),
                                **_forcing(name, seed=2), **{key: True})
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert g.shape in ((160, 3), (160, 5, 3))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="only"):
        _model(name).simulate(**_forcing(name), engine='fused',
                              **{key: True})
    with pytest.raises(TypeError, match=key):
        _model(name).simulate(**_forcing(name), **{key: 1})


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ['Cemaneige', 'CemaneigeGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_single_layer_matches_jax(name, engine):
    """``altitudes=[]``: one layer at station height."""
    want = _jax_simulate(name, 4, seed=3, single_layer=True)
    got = _model(name).simulate(params=_random_params(name, 4, 3),
                                engine=engine,
                                **_forcing(name, seed=3, altitudes=[]))
    assert got.shape == (160, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", HYST_CLASSES)
def test_sca_init_is_inert(name, engine):
    model = _model(name)
    kw = _forcing(name, seed=4)
    a = model.simulate(**kw, sca_init=0.0, engine=engine)
    b = model.simulate(**kw, sca_init=0.9, engine=engine)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# validation: the reference's error types and messages
# ---------------------------------------------------------------------------

_BAD_INPUTS = [
    ("negative prec", lambda kw: kw.update(prec=-kw['prec']), ValueError),
    ("short mean_temp",
     lambda kw: kw.update(mean_temp=kw['mean_temp'][:-1]), RuntimeError),
    ("altitudes not a list",
     lambda kw: kw.update(altitudes=np.array(ALTITUDES)), TypeError),
    ("altitude not a number",
     lambda kw: kw.update(altitudes=[550, 'high']), TypeError),
    ("no station height",
     lambda kw: kw.update(met_station_height=None), ValueError),
    ("station height not a number",
     lambda kw: kw.update(met_station_height='700'), TypeError),
    ("no station height, single layer",
     lambda kw: kw.update(met_station_height=None, altitudes=[]), TypeError),
    ("snow_pack_init not a number",
     lambda kw: kw.update(snow_pack_init='deep'), TypeError),
    ("short etp", lambda kw: kw.update(etp=kw['etp'][:-1]), RuntimeError),
]


@pytest.mark.parametrize("what,mutate,exc", _BAD_INPUTS,
                         ids=[b[0] for b in _BAD_INPUTS])
def test_validation_errors_match_jax(what, mutate, exc):
    name = 'CemaneigeHystGR4JIce'
    kw = _forcing(name, T=30)
    mutate(kw)
    with pytest.raises(Exception) as want:
        _jax_model(name).simulate(**kw)
    with pytest.raises(Exception) as got:
        _model(name).simulate(**kw)
    assert type(got.value) is type(want.value)
    assert type(got.value) is exc
    assert str(got.value) == str(want.value)


def test_frac_ice_and_init_validation():
    kw = _forcing('CemaneigeGR4JIce', T=30)
    with pytest.raises(ValueError, match="flat array"):
        _model('CemaneigeGR4JIce').simulate(
            **dict(kw, frac_ice=np.ones((5, 1))))
    with pytest.raises(ValueError, match="one fraction per layer"):
        _model('CemaneigeGR4JIce').simulate(
            **dict(kw, frac_ice=FRAC_ICE[:3]), engine='fused')
    with pytest.raises(ValueError, match="'s_init'"):
        _model('CemaneigeGR4JIce').simulate(**dict(kw, s_init=1.5))
    with pytest.raises(ValueError, match="engine"):
        _model('CemaneigeGR4JIce').simulate(**kw, engine='pallas')
    with pytest.raises(AttributeError, match="DDF"):
        _model('CemaneigeGR4JIce', params={'CTG': 0.5})


# ---------------------------------------------------------------------------
# what waits, and where it is queued
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CLASSES)
def test_deferred_features_name_their_queue_item(name):
    model, kw = _model(name), _forcing(name, T=30)
    obs = np.ones(30)
    # Forecast mode (item 6) is ported: a final state comes back, and what
    # is not a state bundle is refused by type.
    bundle = 'CemaneigeState' if name == 'Cemaneige' else 'SnowGR4JState'
    _, state = model.simulate(**kw, return_final_state=True)
    assert type(state).__name__ == bundle
    warm_kw = {k: v for k, v in kw.items() if not k.endswith('_init')}
    with pytest.raises(ValueError, match="not both"):
        model.simulate(**kw, initial_state=state)
    with pytest.raises(TypeError, match=f"must be a {bundle}"):
        model.simulate(**warm_kw, initial_state=object())
    with pytest.raises(TypeError, match=f"must be a {bundle}"):
        model.fit(obs, **warm_kw, initial_state=object())
    # The mesh (item 9) is ported: a non-mesh object is refused by type.
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        model.simulate(**kw, mesh=object())
    if name in HYST_CLASSES:
        # The Pareto form (item 8c) is ported, for cold starts only.
        with pytest.raises(ValueError, match="cold starts only"):
            model.fit_Q_SCA(obs, **warm_kw, **_ndsi(30, 0), pareto=True,
                            initial_state=state)
        with pytest.raises(TypeError, match="must be a SnowGR4JState"):
            model.fit_Q_SCA(obs, **warm_kw, **_ndsi(30, 0),
                            initial_state=object())
        with pytest.raises(ValueError, match="engine='scan'"):
            model.fit_Q_SCA(obs, **warm_kw, **_ndsi(30, 0), engine='fused',
                            initial_state=state)


@pytest.mark.parametrize("name", CLASSES)
def test_default_device_is_the_card(name):
    """No ``device=`` means the card: on a machine without CUDA the class
    raises instead of running on the CPU."""
    cls = getattr(models, name)
    assert name in models.__all__
    if torch.cuda.is_available():
        assert cls().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    assert cls(device='cpu').device.type == "cpu"


# ---------------------------------------------------------------------------
# the slice as a whole: Monte-Carlo and calibration
# ---------------------------------------------------------------------------

def _qobs(T, seed, gaps):
    qobs = np.random.default_rng(seed).uniform(0.2, 5, T)
    if gaps:
        qobs[::9] = np.nan
        qobs[30:41] = np.nan
    return qobs


@functools.lru_cache(maxsize=None)
def _jax_monte_carlo(name, gaps):
    np.random.seed(11)
    return jax_monte_carlo(
        _jax_model(name), num=24, qobs=_qobs(160, 5, gaps),
        metrics=('mse', 'rmse', 'nse', 'kge'), return_qsim=False,
        **_forcing(name, seed=5))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,gaps", [
    ('CemaneigeGR4J', False), ('CemaneigeGR4JIce', True),
    ('CemaneigeHystGR4J', True), ('CemaneigeHystGR4JIce', False)])
def test_monte_carlo_matches_jax(name, gaps, engine):
    """Same np.random.seed -> same ensemble; the fused statistics (or the
    scan engine's masked metrics) vs JAX's XLA metrics."""
    want = _jax_monte_carlo(name, gaps)
    np.random.seed(11)
    got = monte_carlo(_model(name), num=24, qobs=_qobs(160, 5, gaps),
                      metrics=('mse', 'rmse', 'nse', 'kge'),
                      return_qsim=False, engine=engine,
                      **_forcing(name, seed=5))
    assert 'qsim' not in got
    np.testing.assert_array_equal(got['params'], want['params'])
    for m in ('mse', 'rmse', 'nse', 'kge'):
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-8,
                                   err_msg=m)


def test_monte_carlo_fused_rejects_unused_kwargs():
    name = 'CemaneigeHystGR4JIce'
    with pytest.raises(ValueError, match="Unused simulate kwargs"):
        monte_carlo(_model(name), num=4, qobs=_qobs(160, 5, False),
                    return_qsim=False, engine='fused', return_storage=False,
                    **_forcing(name, seed=5))
    kw = _forcing(name, seed=5)
    del kw['frac_ice']
    with pytest.raises(ValueError, match="frac_ice"):
        monte_carlo(_model(name), num=4, qobs=_qobs(160, 5, False),
                    return_qsim=False, engine='fused', **kw)


def _jax_losses(name, population, kw, qobs, loss_metric, ndsi=None):
    """JAX's calibration loss of each parameter set of ``population``."""
    cls = getattr(jax_models, name)
    params = np.empty(len(population), dtype=cls._dtype)
    for j, p in enumerate(cls._param_list):
        params[p] = population[:, j]
    loss = jax_metrics.calibration_loss(loss_metric)
    if ndsi is None:
        qsim = np.asarray(cls().simulate(params=params, **kw))
        return np.array([float(loss(qobs, qsim[:, i]))
                         for i in range(len(population))])
    out = cls().simulate(params=params, return_storage=True, **kw)
    qsim, sca = np.asarray(out[0]), np.asarray(out[5])       # sca (T, L, N)
    return np.array([
        0.75 * float(loss(qobs, qsim[:, i])) + 0.05 * sum(
            float(loss(band, 100.0 * sca[:, b, i]))
            for b, band in enumerate(ndsi.values()))
        for i in range(len(population))])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,loss_metric", [
    ('Cemaneige', 'kge'), ('CemaneigeGR4J', 'mse'),
    ('CemaneigeGR4JIce', 'rmse'), ('CemaneigeHystGR4J', 'nse'),
    ('CemaneigeHystGR4JIce', 'kge')])
def test_fit_objective_matches_jax_loss(name, loss_metric, engine):
    """``fit`` gives a finite loss inside the bounds, and the losses of its
    final population equal JAX's calibration loss of the same sets, gaps
    included."""
    kw = _forcing(name, T=120, seed=6)
    qobs = _qobs(120, 6, gaps=True)
    res = _model(name).fit(qobs, **kw, loss_metric=loss_metric,
                           engine=engine, seed=0, maxiter=2)
    cls = getattr(models, name)
    dim = len(cls._param_list)
    assert np.isfinite(res.fun) and res.nit <= 2
    assert res.population.shape == (15 * dim, dim)
    for (lo, hi), v in zip(cls._default_bounds.values(), res.x):
        assert lo <= v <= hi
    picks = np.argsort(res.population_energies)[:5]
    want = _jax_losses(name, res.population[picks], kw, qobs, loss_metric)
    np.testing.assert_allclose(res.population_energies[picks], want,
                               rtol=1e-8)
    assert res.fun == pytest.approx(want[0], rel=1e-8)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,loss_metric,gaps", [
    ('CemaneigeHystGR4J', 'mse', True), ('CemaneigeHystGR4J', 'kge', False),
    ('CemaneigeHystGR4JIce', 'mse', False),
    ('CemaneigeHystGR4JIce', 'kge', True)])
def test_fit_q_sca_objective_matches_jax_loss(name, loss_metric, gaps,
                                              engine):
    """The Q+SCA loss (0.75 on discharge, 0.05 per band) of the final
    population against the reference weighting on JAX's trajectories; with
    gaps, discharge and each NDSI band mask by their own."""
    kw = _forcing(name, T=120, seed=7)
    qobs = _qobs(120, 7, gaps)
    ndsi = _ndsi(120, 7, gaps)
    res = _model(name).fit_Q_SCA(qobs, **kw, **ndsi, loss_metric=loss_metric,
                                 engine=engine, seed=0, maxiter=2)
    assert np.isfinite(res.fun) and res.nit <= 2
    energies = res.population_energies
    picks = np.argsort(np.where(np.isfinite(energies), energies, np.inf))[:5]
    want = _jax_losses(name, res.population[picks], kw, qobs, loss_metric,
                       ndsi)
    np.testing.assert_allclose(energies[picks], want, rtol=1e-8)


def test_fit_q_sca_checks():
    name = 'CemaneigeHystGR4J'
    kw, obs = _forcing(name, T=40), np.ones(40)
    # The fused statistics path supports mse/kge only.
    with pytest.raises(ValueError, match="loss_metric"):
        _model(name).fit_Q_SCA(obs, **kw, **_ndsi(40, 0), loss_metric='nse',
                               engine='fused', maxiter=1)
    with pytest.raises(ValueError, match="loss_metric"):
        _model(name).fit_Q_SCA(obs, **kw, **_ndsi(40, 0), loss_metric='nash')
    with pytest.raises(ValueError, match="elevation bands"):
        _model(name).fit_Q_SCA(
            obs, **dict(kw, altitudes=[550, 700]), **_ndsi(40, 0), maxiter=1)
    with pytest.raises(RuntimeError, match="same length as prec"):
        _model(name).fit_Q_SCA(obs, **kw, **_ndsi(39, 0), maxiter=1)


@pytest.mark.parametrize("name", ['Cemaneige', 'CemaneigeHystGR4JIce'])
def test_all_nan_record_raises(name):
    kw = _forcing(name, T=40)
    with pytest.raises(ValueError, match="no finite value"):
        _model(name).fit(np.full(40, np.nan), **kw, engine='fused',
                         maxiter=1)
    if name == 'Cemaneige':
        return
    ndsi = _ndsi(40, 0)
    ndsi['NDSI3'] = np.full(40, np.nan)
    with pytest.raises(ValueError, match="NDSI band has no finite value"):
        _model(name).fit_Q_SCA(np.ones(40), **kw, **ndsi, engine='fused',
                               maxiter=1)
