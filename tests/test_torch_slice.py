"""PyTorch port, the GR4J slice end to end against the JAX package (CPU).

The public entry points -- ``GR4J.simulate``/``fit``, ``monte_carlo``,
the metrics, ``losses_from_stats`` and ``CAMELSLoader`` -- get the same
inputs as their ``rrmpg_tpu`` counterparts (numpy draws, the same
``np.random.seed`` for Monte-Carlo sampling) and must agree in float64.
Tolerances are stated per test.  DE trajectories cannot match (JAX and
torch draw different random numbers), so calibration is checked through
the objective at JAX's optimum.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.data import CAMELSLoader as JaxCAMELSLoader
from rrmpg_tpu.ops.pallas_snow import losses_from_stats as jax_losses
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.interop import gr4j_state_from_numpy, params_from_numpy
from rrmpg_tpu_torch.models import GR4J, ABCModel, HBVEdu
from rrmpg_tpu_torch.ops import losses_from_stats
from rrmpg_tpu_torch.tools import differential_evolution, monte_carlo
from rrmpg_tpu_torch.utils import metrics

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64
METRICS = ('mse', 'rmse', 'nse', 'kge', 'alpha_nse', 'beta_nse', 'r')


def _series(T, seed=0, gaps=False):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    qobs = rng.uniform(0.2, 5, T)
    if gaps:
        qobs[::9] = np.nan
        qobs[30:50] = np.nan
    return prec, etp, qobs


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_simulate_matches_jax(engine):
    prec, etp, _ = _series(200, seed=1)
    np.random.seed(7)
    params = jax_models.GR4J().get_random_params(num=20)
    want = jax_models.GR4J().simulate(prec, etp, s_init=0.3, r_init=0.6,
                                      params=params)
    got = GR4J(device='cpu', dtype=F64).simulate(prec, etp, s_init=0.3, r_init=0.6,
                                   params=params, engine=engine)
    assert got.shape == want.shape == (200, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def test_simulate_storage_and_errors():
    prec, etp, _ = _series(50)
    model = GR4J(device='cpu', dtype=F64)
    q, s, r = model.simulate(prec, etp, return_storage=True)
    assert q.shape == s.shape == r.shape == (50, 1)
    with pytest.raises(ValueError, match="discharge only"):
        model.simulate(prec, etp, return_storage=True, engine='fused')
    with pytest.raises(ValueError, match="engine"):
        model.simulate(prec, etp, engine='pallas')
    with pytest.raises(ValueError, match="non-negative"):
        model.simulate(-prec, etp)
    with pytest.raises(RuntimeError, match="lengths differ"):
        model.simulate(prec, etp[:-1])
    with pytest.raises(ValueError, match="s_init"):
        model.simulate(prec, etp, s_init=1.5)
    q2, state = model.simulate(prec, etp, return_final_state=True)
    assert torch.equal(q2, model.simulate(prec, etp))
    assert type(state).__name__ == "GR4JState"
    assert state.s.shape == (1,) and state.pr_history.shape == (1, 20)
    with pytest.raises(ValueError, match="discharge only"):
        model.simulate(prec, etp, return_storage=True, engine='fused',
                       return_final_state=True)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("gaps", [False, True])
def test_monte_carlo_matches_jax(engine, gaps):
    """Same np.random.seed -> same ensemble; fused stats (or the scan
    engine's masked metrics) vs JAX's XLA metrics, rtol=1e-8."""
    prec, etp, qobs = _series(150, seed=2, gaps=gaps)
    np.random.seed(11)
    want = jax_monte_carlo(jax_models.GR4J(), num=64, qobs=qobs, prec=prec,
                           etp=etp, metrics=METRICS, engine='xla',
                           return_qsim=False)
    np.random.seed(11)
    got = monte_carlo(GR4J(device='cpu', dtype=F64), num=64, qobs=qobs, prec=prec,
                      etp=etp, metrics=METRICS, engine=engine,
                      return_qsim=False)
    np.testing.assert_array_equal(got['params'], want['params'])
    for m in METRICS:
        if m == 'beta_nse' and gaps and engine == 'fused':
            # As in rrmpg_tpu's fused path (tools/monte_carlo.py:130-135):
            # beta_nse takes the unmasked qobs.mean()/std(), NaN with gaps.
            assert np.isnan(got[m]).all()
            continue
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-8,
                                   err_msg=m)


def test_monte_carlo_qsim_and_batches():
    prec, etp, qobs = _series(80, seed=3)
    np.random.seed(5)
    whole = monte_carlo(GR4J(device='cpu', dtype=F64), num=10, qobs=qobs, prec=prec,
                        etp=etp)
    np.random.seed(5)
    parts = monte_carlo(GR4J(device='cpu', dtype=F64), num=10, qobs=qobs, prec=prec,
                        etp=etp, batch_size=3)
    assert whole['qsim'].shape == (80, 10)
    np.testing.assert_allclose(parts['qsim'], whole['qsim'], rtol=1e-14)
    np.testing.assert_allclose(parts['mse'], whole['mse'], rtol=1e-14)
    with pytest.raises(ValueError, match="qobs"):
        monte_carlo(GR4J(device='cpu'), num=4, prec=prec, etp=etp, return_qsim=False)
    with pytest.raises(ValueError, match="Unknown metric"):
        monte_carlo(GR4J(device='cpu'), num=4, qobs=qobs, prec=prec, etp=etp,
                    metrics=('fdc',))


@pytest.mark.parametrize("gaps", [False, True])
def test_losses_from_stats_match_jax(gaps):
    _, _, qobs = _series(120, seed=4, gaps=gaps)
    rng = np.random.default_rng(4)
    mean_q = rng.uniform(1, 3, 16)
    stats = np.stack([rng.uniform(0.5, 2, 16), mean_q,
                      mean_q ** 2 + rng.uniform(0.1, 1, 16),
                      mean_q * np.nanmean(qobs) + rng.uniform(0, 1, 16)])
    want = jax_losses(stats, qobs)
    got = losses_from_stats(torch.tensor(stats), qobs)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=1e-10, atol=1e-13, err_msg=k)


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("name", ['mse', 'rmse', 'nse', 'kge', 'alpha_nse',
                                  'beta_nse', 'pearson_r'])
def test_masked_metrics_match_jax(name, gaps):
    _, _, obs = _series(90, seed=5, gaps=gaps)
    sim = np.random.default_rng(6).uniform(0, 5, (7, 90))
    want = getattr(jax_metrics, name)(obs[None, :], sim, axis=-1)
    got = getattr(metrics, name)(torch.tensor(obs)[None, :],
                                 torch.tensor(sim), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-13)


def test_masked_metrics_drop_nan_sim_at_gaps():
    """Divergence from rrmpg_tpu's XLA metrics, chosen on purpose: a gap
    step is dropped even where sim is NaN there, as the fused kernels do
    (rrmpg_tpu/utils/metrics.py:93 multiplies 0 * NaN and returns NaN)."""
    _, _, obs = _series(60, seed=7, gaps=True)
    sim = np.random.default_rng(7).uniform(0, 5, 60)
    sim[np.isnan(obs)] = np.nan
    for name in ('mse', 'nse', 'kge'):
        got = getattr(metrics, name)(torch.tensor(obs), torch.tensor(sim))
        valid = np.isfinite(obs)
        clean = getattr(metrics, name)(torch.tensor(obs[valid]),
                                       torch.tensor(sim[valid]))
        assert np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), clean.item(), rtol=1e-12)
        assert np.isnan(float(getattr(jax_metrics, name)(obs, sim)))
    # A NaN sim at a valid step still propagates.
    sim[1 if np.isfinite(obs[1]) else 2] = np.nan
    assert np.isnan(metrics.mse(torch.tensor(obs), torch.tensor(sim)).item())


@pytest.mark.parametrize("name", ['calc_nse', 'calc_mse', 'calc_rmse',
                                  'calc_kge', 'calc_alpha_nse',
                                  'calc_beta_nse'])
def test_calc_wrappers_match_jax(name):
    _, _, obs = _series(70, seed=8, gaps=True)
    sim = np.random.default_rng(8).uniform(0, 5, 70)
    assert getattr(metrics, name)(obs, sim) == pytest.approx(
        getattr(jax_metrics, name)(obs, sim), rel=1e-12)
    with pytest.raises(RuntimeError):
        getattr(metrics, name)(np.ones(5), np.ones(5)) if name in (
            'calc_nse', 'calc_kge', 'calc_alpha_nse', 'calc_beta_nse') \
            else metrics.calc_mse(np.full(5, np.nan), np.ones(5))
    r, p = metrics.calc_r(obs, sim)
    assert (r, p) == pytest.approx(tuple(jax_metrics.calc_r(obs, sim)),
                                   rel=1e-12)


def test_fit_objective_at_jax_optimum():
    """fit(engine='fused', maxiter=3) gives a finite loss inside the
    bounds; the port's batch objective at JAX's optimum equals JAX's
    ``res.fun`` (rtol=1e-8), for the fused and the scan engine."""
    prec, etp, qobs = _series(120, seed=9)
    jres = jax_models.GR4J().fit(qobs, prec, etp, seed=0, maxiter=3)
    model = GR4J(device='cpu', dtype=F64)
    res = model.fit(qobs, prec, etp, engine='fused', seed=0, maxiter=3)
    assert np.isfinite(res.fun) and res.nit <= 3
    assert res.nfev == 60 * (res.nit + 1)
    for (lo, hi), v in zip(GR4J._default_bounds.values(), res.x):
        assert lo <= v <= hi
    assert res.population.shape == (60, 4)
    x = torch.tensor(np.asarray(jres.x))[None, :]
    for engine in ('fused', 'scan'):
        obj = model._batch_objective(torch.tensor(qobs), torch.tensor(prec),
                                     torch.tensor(etp), 0.0, 0.0, 'mse',
                                     engine)
        assert obj(x).item() == pytest.approx(jres.fun, rel=1e-8)


@pytest.mark.parametrize("loss_metric", ['rmse', 'nse', 'kge'])
def test_fit_objectives_match_jax_losses(loss_metric):
    """Each loss of the fused (stats) and scan objectives equals JAX's
    calibration loss on the same candidates, gaps included."""
    prec, etp, qobs = _series(120, seed=10, gaps=True)
    np.random.seed(3)
    params = jax_models.GR4J().get_random_params(num=6)
    qsim = np.asarray(jax_models.GR4J().simulate(prec, etp, params=params))
    want = np.asarray(jax_metrics.calibration_loss(loss_metric)(
        qobs[:, None], qsim) if loss_metric != 'rmse' else
        jax_metrics.rmse(qobs[:, None], qsim, axis=0))
    if loss_metric != 'rmse':
        want = 1.0 - np.asarray(getattr(jax_metrics, loss_metric)(
            qobs[:, None], qsim, axis=0))
    X = torch.tensor(np.stack([params[n] for n in GR4J._param_list], 1))
    model = GR4J(device='cpu', dtype=F64)
    for engine in ('fused', 'scan'):
        obj = model._batch_objective(torch.tensor(qobs), torch.tensor(prec),
                                     torch.tensor(etp), 0.0, 0.0,
                                     loss_metric, engine)
        np.testing.assert_allclose(obj(X).numpy(), want, rtol=1e-8)


def test_de_minimizes_and_is_reproducible():
    bounds = [(-5.0, 5.0), (-5.0, 5.0), (0.0, 10.0)]

    def sphere(X):
        return ((X - torch.tensor([1.0, -2.0, 3.0], dtype=F64)) ** 2).sum(1)

    a = differential_evolution(sphere, bounds, seed=3, batched=True,
                               device='cpu', dtype=F64)
    b = differential_evolution(sphere, bounds, seed=3, batched=True,
                               device='cpu', dtype=F64)
    assert a.success and a.fun < 1e-3
    np.testing.assert_allclose(a.x, [1.0, -2.0, 3.0], atol=0.05)
    np.testing.assert_array_equal(a.population, b.population)
    assert a.nfev == 45 * (a.nit + 1)


def test_de_quarantines_nonfinite_members():
    bounds = [(0.0, 1.0), (0.0, 1.0)]

    def objective(X):
        out = (X ** 2).sum(1)
        return torch.where(X[:, 0] > 0.9, torch.nan, out)

    res = differential_evolution(objective, bounds, seed=0, maxiter=5,
                                 batched=True, device='cpu', dtype=F64)
    assert np.isfinite(res.fun)
    members, energies = res.nonfinite_members()
    assert members.shape[1] == 2 and not np.isfinite(energies).any()


def test_model_parameter_registry():
    model = GR4J(device='cpu', dtype=F64)
    params = model.get_random_params(num=5)
    assert params.dtype == jax_models.GR4J().get_dtype()
    pd_, num = model._prepare_params(params)
    assert num == 5 and pd_['x1'].dtype == F64 and pd_['x1'].shape == (5,)
    np.testing.assert_array_equal(pd_['x4'].numpy(), params['x4'])
    gen = torch.Generator().manual_seed(0)
    sampled = model.sample_params(gen, 1000)
    for name, (lo, hi) in GR4J._default_bounds.items():
        assert sampled[name].shape == (1000,)
        assert lo <= sampled[name].min() and sampled[name].max() <= hi
    model.set_params(params[2])
    assert model.get_params()['x1'] == params['x1'][2]
    with pytest.raises(AttributeError):
        model.set_params({'x9': 1.0})
    with pytest.raises(AttributeError):
        GR4J(params={'x1': 1.0}, device='cpu')
    with pytest.raises(TypeError):
        GR4J(device='cpu', dtype=torch.float16)
    np.testing.assert_array_equal(
        params_from_numpy(params, device='cpu', dtype=F64)['x2'].numpy(), params['x2'])


def test_default_device_is_the_card_and_never_falls_back():
    """Every entry point defaults to the card: on a machine without CUDA
    it raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA path is not reachable")
    params = {'x1': np.array([300.0])}
    state = {'s': 1.0, 'r': 2.0, 'pr_history': np.zeros(20)}
    for entry in (GR4J, ABCModel, HBVEdu,
                  lambda: differential_evolution(lambda X: X.sum(1),
                                                 [(0.0, 1.0)]),
                  lambda: params_from_numpy(params),
                  lambda: gr4j_state_from_numpy(state)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
    assert GR4J(device='cpu').device.type == 'cpu'


def test_camels_loader_matches_jax(tmp_path):
    pd.testing.assert_frame_equal(CAMELSLoader().load_basin('01031500'),
                                  JaxCAMELSLoader().load_basin('01031500'))
    assert CAMELSLoader().get_basin_numbers() == ['01031500']
    assert CAMELSLoader().get_station_height('01031500') == 318.0
    with pytest.raises(ValueError):
        CAMELSLoader().load_basin('99999999')
    # A user directory whose discharge holds -999 sentinels: NaN in both.
    src = REPO / 'rrmpg_tpu' / 'data' / 'camels'
    shutil.copy(src / '01031500_lump_cida_forcing_leap.txt', tmp_path)
    lines = (src / '01031500_05_model_output.txt').read_text().splitlines()
    header = lines[0].split()
    col = header.index('OBS_RUN')
    for i in (400, 401, 900):
        fields = lines[i].split()
        fields[col] = '-999.00'
        lines[i] = ' '.join(fields)
    (tmp_path / '01031500_05_model_output.txt').write_text(
        '\n'.join(lines) + '\n')
    got = CAMELSLoader(data_dir=tmp_path).load_basin('01031500')
    want = JaxCAMELSLoader(data_dir=tmp_path).load_basin('01031500')
    pd.testing.assert_frame_equal(got, want)
    assert got['QObs(mm/d)'].isna().sum() >= 1


def test_port_never_imports_jax():
    """Every module of the port (and chip_smoke.py) imports with JAX
    blocked, and no source line imports it."""
    pkg = REPO / 'rrmpg_tpu_torch'
    modules = sorted(
        '.'.join(p.relative_to(REPO).with_suffix('').parts).replace(
            '.__init__', '') for p in pkg.rglob('*.py'))
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['rrmpg_tpu'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "import chip_smoke")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for path in [*pkg.rglob('*.py'), REPO / 'chip_smoke.py',
                 REPO / 'profile_port.py']:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(('import jax', 'from jax',
                                            'import rrmpg_tpu.',
                                            'from rrmpg_tpu.',
                                            'from rrmpg_tpu ')), (path, line)


def test_no_fallback_around_kernels():
    """No try/except around a kernel launch or build in the port's ops:
    a CUDA tensor launches its kernel or raises."""
    for path in (REPO / 'rrmpg_tpu_torch' / 'ops').glob('*.py'):
        assert 'try:' not in path.read_text(), path
