"""PyTorch port, the device mesh against JAX's 8-device CPU mesh (float64).

``tests/conftest.py`` gives JAX eight virtual CPU devices; the port's
counterpart is a mesh that names the CPU eight times
(``default_mesh(['cpu'] * 8)``: each entry is one shard).  Every ``mesh=``
entry point is held to its run without a mesh and, where the two packages
compute the same numbers, to JAX's sharded run:

* the mesh helpers and ``pad_to_multiple`` to JAX's;
* ``sharded_call``'s order on a 2 x 2 and an 8-shard mesh: every shard's
  inputs placed before the first shard runs, the shards in grid order;
* ``ensemble_run`` / ``ensemble_objective`` with ``run_gr4j`` at N = 13
  (padded to 16) and from a warm state to the unsharded port and to JAX's
  ``ensemble_run`` at ``rtol=1e-12`` (the same float64 equations);
* ``simulate(mesh=)`` of all eight classes (cold, and for GR4J forecast
  mode) and ``monte_carlo(mesh=)`` to the port without a mesh and to JAX's
  ``simulate(mesh=)`` / ``monte_carlo(mesh=)``;
* DE's padded population to JAX's (15 x 4 on 8 shards is 64);
* ``fit(mesh=)`` on both engines, checkpoint and resume under a mesh,
  ``random_search``, SCE-UA, DE-MC, Sobol' and Morris to their unsharded
  runs; Sobol' and Morris also to JAX's mesh runs (the same host design);
  ``fit(method='sce', mesh=)`` on the 'scan' engine (F8) to the unsharded
  SCE fit and its ``fun`` to JAX's MSE at ``x``;
* the regional objectives on a 2 x 4 (ensemble, catchment) mesh to the
  unsharded port and JAX's 2-D mesh;
* every ``ValueError`` JAX raises under a mesh.

"Equal" on the CPU: the fused plain versions and the ``'scan'`` ops give
each member's numbers wherever it sits, but ATen's vectorized ``pow`` and
its scalar tail (libm) agree only to an ulp, and a member's place in its
shard decides which one it takes.  So sharded results are held to the
unsharded ones at ``rtol=1e-12`` (a calibration: the same population, the
energies at ``rtol=1e-12``); on the card the kernels are bit-equal
(``chip_smoke.py`` phase ``mesh``, ``tests/test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rrmpg_tpu.models as jax_models
import rrmpg_tpu.parallel as jax_parallel
from rrmpg_tpu.ops import run_gr4j as jax_run_gr4j
from rrmpg_tpu.ops.gr4j import GR4JState as JaxGR4JState
from rrmpg_tpu.ops.gr4j import run_gr4j_warm as jax_run_gr4j_warm
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.tools import morris_screening as jax_morris
from rrmpg_tpu.tools import sobol_indices as jax_sobol
from rrmpg_tpu.tools.calibration import \
    differential_evolution as jax_differential_evolution
from rrmpg_tpu_torch import interop, models, parallel
from rrmpg_tpu_torch.ops import run_gr4j, run_gr4j_warm
from rrmpg_tpu_torch.parallel import (
    CATCHMENT_AXIS, ENSEMBLE_AXIS, Mesh, default_mesh,
    ensemble_catchment_mesh, ensemble_objective, ensemble_run,
    pad_to_multiple, regional_gr4j_objective, regional_run,
    regional_snow_objective, replicate, shard_leading_axis)
from rrmpg_tpu_torch.tools import (demc_sample, differential_evolution,
                                   monte_carlo, morris_screening,
                                   random_search, sce_ua, sobol_indices)
from rrmpg_tpu_torch.utils import tracing

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
RTOL = 1e-12
CLASSES = ('GR4J', 'HBVEdu', 'ABCModel', 'Cemaneige', 'CemaneigeGR4J',
           'CemaneigeGR4JIce', 'CemaneigeHystGR4J', 'CemaneigeHystGR4JIce')
SNOW_CLASSES = CLASSES[3:]


@pytest.fixture(scope="module")
def mesh():
    return default_mesh(['cpu'] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jax_parallel.default_mesh()


def _gr4j_params(n, seed=0):
    rng = np.random.default_rng(seed)
    return {'x1': rng.uniform(100, 1200, n), 'x2': rng.uniform(-5, 3, n),
            'x3': rng.uniform(20, 300, n), 'x4': rng.uniform(1.1, 2.9, n)}


def _t(params):
    return {k: torch.as_tensor(v, dtype=F64) for k, v in params.items()}


def _forcing(T=80, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 15, T), rng.uniform(0, 4, T), rng.uniform(0, 5, T)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_mesh_helpers_match_jax(mesh, jax_mesh):
    assert mesh.shape == dict(jax_mesh.shape) == {'ensemble': 8}
    assert mesh.size == jax_mesh.size == 8
    assert mesh.axis_names == jax_mesh.axis_names
    got = ensemble_catchment_mesh(4, 2, devices=['cpu'] * 8)
    want = jax_parallel.ensemble_catchment_mesh(ensemble=4, catchment=2)
    assert got.shape == dict(want.shape) == {'ensemble': 4, 'catchment': 2}
    assert got.devices.shape == want.devices.shape == (4, 2)
    # ensemble defaults to the devices over the catchment axis
    assert ensemble_catchment_mesh(catchment=4,
                                   devices=['cpu'] * 8).shape == dict(
        jax_parallel.ensemble_catchment_mesh(catchment=4).shape)
    assert (ENSEMBLE_AXIS, CATCHMENT_AXIS) == (jax_parallel.ENSEMBLE_AXIS,
                                               jax_parallel.CATCHMENT_AXIS)
    assert all(d == torch.device('cpu') for d in mesh.devices.ravel())
    assert not mesh.processes.any()


@pytest.mark.parametrize("n,m", [(1, 8), (8, 8), (13, 8), (60, 4), (0, 3),
                                 (65, 1)])
def test_pad_to_multiple_matches_jax(n, m):
    assert pad_to_multiple(n, m) == jax_parallel.pad_to_multiple(n, m)


def test_default_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu', \.\.\.\]"):
        default_mesh()
    with pytest.raises(RuntimeError, match=r"devices=\['cpu', \.\.\.\]"):
        ensemble_catchment_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        default_mesh(['cuda:0'])
    with pytest.raises(ValueError, match="needs 8 devices"):
        ensemble_catchment_mesh(4, 2, devices=['cpu'] * 4)


def test_shard_leading_axis_and_replicate(mesh):
    tree = {'a': torch.arange(16.0), 'b': (torch.ones(16, 3), 2.5)}
    shards = shard_leading_axis(tree, mesh)
    assert len(shards) == 8
    torch.testing.assert_close(torch.cat([s['a'] for s in shards]),
                               tree['a'], rtol=0, atol=0)
    assert all(s['b'][0].shape == (2, 3) and s['b'][1] == 2.5
               for s in shards)
    with pytest.raises(ValueError, match="does not divide"):
        shard_leading_axis(torch.arange(13.0), mesh)
    copies = replicate(tree, mesh)
    assert list(copies) == [torch.device('cpu')]   # one distinct device
    assert copies[torch.device('cpu')]['a'] is tree['a']
    with pytest.raises(TypeError, match="parallel.Mesh"):
        replicate(tree, jax.devices())


def test_sharded_call_launches_every_shard_then_gathers(mesh):
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x * 2, {'sum': x.sum(dim=1)}

    x = torch.arange(26.0).reshape(13, 2)
    doubled, sums = parallel.mesh.sharded_call(
        fn, mesh, (x,), (ENSEMBLE_AXIS,), (ENSEMBLE_AXIS,))
    assert seen == [2] * 8                     # 13 padded to 16
    torch.testing.assert_close(doubled, 2 * x, rtol=0, atol=0)
    torch.testing.assert_close(sums['sum'], x.sum(dim=1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.mesh.sharded_call(fn, mesh, (x,), (ENSEMBLE_AXIS,),
                                   (ENSEMBLE_AXIS,), pad=False)
    with pytest.raises(ValueError, match="no axis 'catchment'"):
        parallel.mesh.sharded_call(fn, mesh, (x,), (CATCHMENT_AXIS,),
                                   (CATCHMENT_AXIS,))


@pytest.mark.parametrize("grid", ["2x2", "8"])
def test_sharded_call_places_every_shard_before_it_launches_one(grid, mesh):
    """Every shard's inputs are copied before the first shard's ``fn`` runs
    (a copy between cards runs on its source card's stream, behind what an
    earlier shard launched there); the shards then run in grid order, and
    the result is the unsharded computation's bit for bit."""
    if grid == "8":
        m, cat = mesh, None
    else:
        m = ensemble_catchment_mesh(2, 2, devices=['cpu'] * 4)
        cat = CATCHMENT_AXIS
    seen = []

    def fn(q, p, w):
        seen.append(float(p[0]))
        return q[:, :1] * p[None, :] + w

    q = torch.arange(18.0, dtype=F64).reshape(6, 3)
    p = torch.linspace(0.5, 2.0, 13, dtype=F64)
    w = torch.tensor(0.25, dtype=F64)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = parallel.mesh.sharded_call(
                fn, m, (q, p, w), (cat, ENSEMBLE_AXIS, None),
                (cat, ENSEMBLE_AXIS))
        spans = tracing.spans()
    finally:
        tracing.reset()
    torch.testing.assert_close(got, q[:, :1] * p[None, :] + w, rtol=0,
                               atol=0)
    (call,) = [s for s in spans if s["name"] == "mesh.call"]
    copies, shards = ([s for s in spans if s["name"] == name]
                      for name in ("mesh.copy", "mesh.shard"))
    assert {s["parent"] for s in copies + shards} == {call["id"]}
    first = min(shards, key=lambda s: s["id"])
    assert all(c["id"] < first["id"] and c["end_ns"] <= first["start_ns"]
               for c in copies)
    expect = [{"device": "cpu", "shard": i} for i in range(m.size)]
    for group in (copies, shards):
        assert [s["attrs"] for s in sorted(group, key=lambda s: s["id"])] \
            == expect
    k = m.shape[ENSEMBLE_AXIS]
    padded = torch.cat([p, p[:1].repeat(pad_to_multiple(13, k) - 13)])
    chunk = len(padded) // k
    assert seen == [float(padded[e * chunk]) for e in range(k)
                    for _ in range(m.shape.get(CATCHMENT_AXIS, 1))]


# ---------------------------------------------------------------------------
# ensemble_run / ensemble_objective
# ---------------------------------------------------------------------------

def test_ensemble_run_pads_and_matches_jax(mesh, jax_mesh):
    prec, etp, _ = _forcing()
    params = _gr4j_params(13)
    got = ensemble_run(run_gr4j, (prec, etp, 0.3, 0.2), _t(params), mesh)
    plain = run_gr4j(torch.as_tensor(prec), torch.as_tensor(etp), 0.3, 0.2,
                     _t(params))
    want = jax_parallel.ensemble_run(jax_run_gr4j, (prec, etp, 0.3, 0.2),
                                     {k: jnp.asarray(v)
                                      for k, v in params.items()},
                                     jax_mesh)
    assert len(got) == 3 and got[0].shape == (13, 80)
    for g, p, w in zip(got, plain, want):
        _close(g, p)
        _close(g, w)


def test_ensemble_run_warm_state_matches_jax(mesh, jax_mesh):
    prec, etp, _ = _forcing()
    params = _gr4j_params(13, seed=2)
    *_, state = run_gr4j(torch.as_tensor(prec[:40]),
                         torch.as_tensor(etp[:40]), 0.4, 0.5, _t(params),
                         return_final=True)
    got = ensemble_run(run_gr4j_warm, (prec[40:], etp[40:]), _t(params),
                       mesh, state=state)
    plain = run_gr4j_warm(torch.as_tensor(prec[40:]),
                          torch.as_tensor(etp[40:]), state, _t(params))
    jax_state = JaxGR4JState(*(jnp.asarray(x.numpy()) for x in state))
    want = jax_parallel.ensemble_run(
        jax_run_gr4j_warm, (prec[40:], etp[40:]),
        {k: jnp.asarray(v) for k, v in params.items()}, jax_mesh,
        state=jax_state)
    for g, p, w in zip(got[:3], plain[:3], want[:3]):
        _close(g, p)
        _close(g, w)
    for g, p, w in zip(got[3], plain[3], want[3]):    # the final state
        _close(g, p)
        _close(g, w)


def test_ensemble_objective_matches_jax(mesh, jax_mesh):
    prec, etp, _ = _forcing()
    params = _gr4j_params(16, seed=7)
    target = run_gr4j(torch.as_tensor(prec), torch.as_tensor(etp), 0.2,
                      0.2, _t(params))[0][5].numpy().copy()
    target[::9] = np.nan                                 # gaps are masked
    losses, best, best_loss = ensemble_objective(
        run_gr4j, (prec, etp, 0.2, 0.2), _t(params), target, mesh)
    want = jax_parallel.ensemble_objective(
        jax_run_gr4j, (prec, etp, 0.2, 0.2),
        {k: jnp.asarray(v) for k, v in params.items()}, target, jax_mesh)
    assert int(best) == int(want[1]) == 5 and float(best_loss) < 1e-20
    _close(losses, want[0], rtol=1e-10)


# ---------------------------------------------------------------------------
# the model classes: simulate(mesh=), monte_carlo(mesh=)
# ---------------------------------------------------------------------------

def _class_inputs(name, T=40):
    """Keyword inputs of ``name``'s simulate (both packages)."""
    rng = np.random.default_rng(11)
    if name == 'GR4J':
        return dict(prec=rng.uniform(0, 15, T), etp=rng.uniform(0, 4, T),
                    s_init=0.3, r_init=0.4)
    if name == 'ABCModel':
        return dict(prec=rng.uniform(0, 15, T))
    if name == 'HBVEdu':
        return dict(temp=rng.uniform(-5, 15, T), prec=rng.uniform(0, 10, T),
                    month=np.arange(T) % 12 + 1, PE_m=rng.uniform(0, 3, 12),
                    T_m=rng.uniform(-5, 15, 12), soil_init=100.0)
    mean_t = rng.uniform(-9, 13, T)
    kw = dict(prec=rng.uniform(0, 14, T), mean_temp=mean_t,
              min_temp=mean_t - rng.uniform(0.5, 4, T),
              max_temp=mean_t + rng.uniform(0.5, 4, T),
              met_station_height=700, altitudes=[550, 620, 700, 785, 920])
    if name != 'Cemaneige':
        kw['etp'] = rng.uniform(0, 3, T)
    if 'Ice' in name:
        kw['frac_ice'] = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    return kw


@functools.lru_cache(maxsize=None)
def _class_params(name, num=12):
    np.random.seed(21)
    return getattr(jax_models, name)().get_random_params(num=num)


@pytest.mark.parametrize("name", CLASSES)
def test_simulate_mesh_matches_unsharded_and_jax(name, mesh, jax_mesh):
    kw, params = _class_inputs(name), _class_params(name)
    model = getattr(models, name)(**CPU)
    storage = 'return_storages' if name == 'Cemaneige' else 'return_storage'
    got = model.simulate(**kw, params=params, mesh=mesh, **{storage: True})
    plain = model.simulate(**kw, params=params, **{storage: True})
    want = getattr(jax_models, name)().simulate(
        **kw, params=params, mesh=jax_mesh, **{storage: True})
    assert len(got) == len(plain) == len(want) >= 2
    assert got[0].shape == (40, 12)
    for g, p, w in zip(got, plain, want):
        _close(g, p)
        _close(g, w, rtol=1e-9)


@pytest.mark.parametrize("name", ('GR4J', 'HBVEdu', 'ABCModel', 'Cemaneige',
                                  'CemaneigeHystGR4JIce'))
def test_forecast_mode_on_a_mesh(name, mesh):
    """Spin-up with a final state, then a warm continuation from it, both
    split over the mesh (the state split with the members)."""
    kw, params = _class_inputs(name), _class_params(name)
    model = getattr(models, name)(**CPU)
    q, state = model.simulate(**kw, params=params, mesh=mesh,
                              return_final_state=True)
    q_plain, state_plain = model.simulate(**kw, params=params,
                                          return_final_state=True)
    _close(q, q_plain)
    leaves = parallel.mesh.tree_leaves
    for g, p in zip(leaves(state), leaves(state_plain)):
        _close(g, p)
    warm = {k: v for k, v in kw.items() if not k.endswith('_init')}
    if name == 'ABCModel':
        warm = dict(warm)
    got = model.simulate(**warm, params=params, mesh=mesh,
                         initial_state=state)
    want = model.simulate(**warm, params=params, initial_state=state_plain)
    _close(got, want)


def test_monte_carlo_mesh_matches_unsharded_and_jax(mesh, jax_mesh):
    kw, qobs = _class_inputs('GR4J'), _forcing(T=40)[2]
    np.random.seed(5)
    got = monte_carlo(models.GR4J(**CPU), 13, qobs, mesh,
                      metrics=('mse', 'kge'), **kw)
    np.random.seed(5)
    plain = monte_carlo(models.GR4J(**CPU), 13, qobs, metrics=('mse', 'kge'),
                        **kw)
    np.random.seed(5)
    want = jax_monte_carlo(jax_models.GR4J(), 13, qobs, jax_mesh,
                           metrics=('mse', 'kge'), **kw)
    for key in ('qsim', 'mse', 'kge'):
        _close(got[key], plain[key])
        _close(got[key], want[key], rtol=1e-10)


# ---------------------------------------------------------------------------
# calibration and the analysis tools
# ---------------------------------------------------------------------------

TARGET = np.array([0.5, -1.0, 2.0, 0.1])
BOUNDS4 = [(-2, 2), (-3, 3), (0, 5), (-1, 1)]


def _quadratic(x):
    return ((x - torch.as_tensor(TARGET, dtype=x.dtype)) ** 2).sum()


def _quadratic_batched(X):
    return ((X - torch.as_tensor(TARGET, dtype=X.dtype)) ** 2).sum(1)


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.population, want.population)
    np.testing.assert_array_equal(got.x, want.x)
    _close(got.population_energies, want.population_energies)
    assert (got.nit, got.nfev) == (want.nit, want.nfev)


def test_de_pads_the_population_as_jax_does(mesh, jax_mesh):
    got = differential_evolution(_quadratic, BOUNDS4, seed=3, popsize=15,
                                 maxiter=1, mesh=mesh, **CPU)
    want = jax_differential_evolution(
        lambda x: jnp.sum((x - jnp.asarray(TARGET)) ** 2), BOUNDS4, seed=3,
        popsize=15, maxiter=1, mesh=jax_mesh)
    assert got.population.shape == np.asarray(want.population).shape \
        == (64, 4)
    assert got.nfev == want.nfev == 128


@pytest.mark.parametrize("batched", [False, True])
def test_de_mesh_matches_unsharded(mesh, batched):
    obj = _quadratic_batched if batched else _quadratic
    got = differential_evolution(obj, BOUNDS4, seed=3, popsize=16,
                                 maxiter=25, batched=batched, mesh=mesh,
                                 **CPU)
    want = differential_evolution(obj, BOUNDS4, seed=3, popsize=16,
                                  maxiter=25, batched=batched, **CPU)
    _assert_same_run(got, want)


def _gr4j_fit_case(T=50):
    prec, etp, _ = _forcing(T=T, seed=8)
    truth = models.GR4J(params={'x1': 320., 'x2': 1.0, 'x3': 90.,
                                'x4': 1.9}, **CPU)
    qobs = truth.simulate(prec, etp).numpy().ravel().copy()
    qobs[::7] = np.nan
    return qobs, prec, etp


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("loss_metric", ["mse", "kge"])
def test_gr4j_fit_mesh_matches_unsharded(mesh, engine, loss_metric):
    qobs, prec, etp = _gr4j_fit_case()
    kw = dict(engine=engine, loss_metric=loss_metric, seed=0, popsize=8,
              maxiter=4)
    got = models.GR4J(**CPU).fit(qobs, prec, etp, mesh=mesh, **kw)
    want = models.GR4J(**CPU).fit(qobs, prec, etp, **kw)
    assert got.population.shape == (32, 4)
    _assert_same_run(got, want)


@pytest.mark.parametrize("name", ('HBVEdu', 'CemaneigeHystGR4JIce'))
def test_fused_fit_and_fit_q_sca_mesh_match_unsharded(name, mesh):
    model = getattr(models, name)(**CPU)
    kw = _class_inputs(name, T=30)
    obs = np.random.default_rng(3).uniform(0.5, 4, 30)
    obs[5::11] = np.nan
    fit = dict(engine='fused', seed=1, popsize=8, maxiter=2)
    _assert_same_run(model.fit(obs, **kw, mesh=mesh, **fit),
                     model.fit(obs, **kw, **fit))
    if name == 'CemaneigeHystGR4JIce':
        ndsi = {f'NDSI{i + 1}': np.random.default_rng(i).uniform(0, 100, 30)
                for i in range(5)}
        _assert_same_run(model.fit_Q_SCA(obs, **kw, **ndsi, mesh=mesh, **fit),
                         model.fit_Q_SCA(obs, **kw, **ndsi, **fit))


def test_checkpoint_resume_under_a_mesh(mesh, tmp_path):
    """A fused fit on the mesh, broken off at 4 generations and resumed to
    6, equals the unbroken mesh run bit for bit."""
    qobs, prec, etp = _gr4j_fit_case()
    path = str(tmp_path / "de.npz")
    kw = dict(engine='fused', seed=2, popsize=8, tol=0.0, mesh=mesh)
    models.GR4J(**CPU).fit(qobs, prec, etp, maxiter=4, checkpoint_path=path,
                           checkpoint_every=2, **kw)
    resumed = models.GR4J(**CPU).fit(qobs, prec, etp, maxiter=6,
                                     resume_from=path, **kw)
    unbroken = models.GR4J(**CPU).fit(qobs, prec, etp, maxiter=6, **kw)
    assert resumed.nit == unbroken.nit == 6
    np.testing.assert_array_equal(resumed.population, unbroken.population)
    np.testing.assert_array_equal(resumed.population_energies,
                                  unbroken.population_energies)


def _sample(generator, n):
    return -2 + 4 * torch.rand((n, 4), generator=generator, dtype=F64)


@pytest.mark.parametrize("batched", [False, True])
def test_random_search_mesh_matches_unsharded(mesh, batched):
    obj = _quadratic_batched if batched else _quadratic
    got = random_search(obj, _sample, 512, seed=0, batch_size=128,
                        batched=batched, mesh=mesh, **CPU)
    want = random_search(obj, _sample, 512, seed=0, batch_size=128,
                         batched=batched, **CPU)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.fun == want.fun and got.nfev == want.nfev == 512
    # a size the shards do not divide is rounded up, as JAX's is
    odd = random_search(obj, _sample, 13, seed=0, batched=batched, mesh=mesh,
                        **CPU)
    assert odd.nfev == 16 and odd.population.shape == (16, 4)


def test_sce_mesh_matches_unsharded(mesh):
    got = sce_ua(_quadratic, BOUNDS4, seed=1, maxiter=5, mesh=mesh, **CPU)
    want = sce_ua(_quadratic, BOUNDS4, seed=1, maxiter=5, n_complexes=8,
                  **CPU)
    _assert_same_run(got, want)                 # p = 4 rounded up to 8


@pytest.mark.parametrize("name", ('GR4J', 'HBVEdu', 'ABCModel',
                                  'CemaneigeHystGR4J'))
def test_sce_fit_on_a_mesh_matches_unsharded_and_jax(name, mesh):
    """F8: ``fit(method='sce', mesh=)`` on the 'scan' engine hands SCE-UA
    the per-point form of the class's objective (its ``vmap`` is one
    batched call a shard), as JAX's XLA objective is per point: the run
    equals the unsharded SCE fit with the complexes the mesh rounds to,
    and ``fun`` is the MSE of JAX's ``simulate`` at ``x``."""
    kw = _class_inputs(name, T=30)
    obs = np.random.default_rng(3).uniform(0.5, 4, 30)
    obs[5::11] = np.nan
    model = getattr(models, name)(**CPU)
    dim = len(model._param_list)
    fit = dict(method='sce', seed=1, maxiter=1)
    got = model.fit(obs, **kw, mesh=mesh, **fit)
    want = model.fit(obs, **kw, n_complexes=pad_to_multiple(max(2, dim), 8),
                     **fit)
    _assert_same_run(got, want)
    jax_model = getattr(jax_models, name)(
        params=dict(zip(model._param_list, got.x)))
    out = jax_model.simulate(**kw)
    q = np.asarray(out[0] if isinstance(out, tuple) else out)[:, 0]
    assert got.fun == pytest.approx(np.nanmean((q - obs) ** 2), rel=RTOL)


def test_demc_mesh_matches_unsharded(mesh):
    def log_prob(x):
        return -0.5 * ((x - torch.as_tensor(TARGET, dtype=x.dtype)) ** 2
                       ).sum()

    got = demc_sample(log_prob, BOUNDS4, num_steps=40, seed=2, mesh=mesh,
                      **CPU)
    want = demc_sample(log_prob, BOUNDS4, num_steps=40, seed=2,
                       num_chains=8, **CPU)
    np.testing.assert_array_equal(got.samples, want.samples)
    _close(got.log_probs, want.log_probs)
    # the chain count: a shard-count multiple (of twice it, for an odd one)
    three = default_mesh(['cpu'] * 3)
    odd = demc_sample(log_prob, BOUNDS4, num_steps=4, seed=2, mesh=three,
                      **CPU)
    assert odd.samples.shape[1] == 12


def _ishigami(x):
    return (torch.sin(x[0]) + 7.0 * torch.sin(x[1]) ** 2
            + 0.1 * x[2] ** 4 * torch.sin(x[0]))


def _jax_ishigami(x):
    return (jnp.sin(x[0]) + 7.0 * jnp.sin(x[1]) ** 2
            + 0.1 * x[2] ** 4 * jnp.sin(x[0]))


@pytest.mark.parametrize("batch_size", [None, 50])
def test_sobol_and_morris_mesh_match_unsharded_and_jax(mesh, jax_mesh,
                                                       batch_size):
    bounds = [(-np.pi, np.pi)] * 3
    kw = dict(seed=5, batch_size=batch_size, bootstrap=10)
    runs = [
        (sobol_indices(_ishigami, bounds, n=128, mesh=mesh, **kw, **CPU),
         sobol_indices(_ishigami, bounds, n=128, **kw, **CPU),
         jax_sobol(_jax_ishigami, bounds, n=128, mesh=jax_mesh, **kw)),
        (morris_screening(_ishigami, bounds, num_trajectories=20, mesh=mesh,
                          **kw, **CPU),
         morris_screening(_ishigami, bounds, num_trajectories=20, **kw,
                          **CPU),
         jax_morris(_jax_ishigami, bounds, num_trajectories=20,
                    mesh=jax_mesh, **kw))]
    for got, plain, want in runs:
        for field in want._fields:
            g, p, w = (getattr(r, field) for r in (got, plain, want))
            if isinstance(w, (tuple, int)) or w is None:
                assert g == p == w, field
            else:
                _close(g, p)
                _close(g, w, rtol=1e-10)


# ---------------------------------------------------------------------------
# regional mode on a 2 x 4 (ensemble, catchment) mesh
# ---------------------------------------------------------------------------

C, T_REG, L, N = 4, 120, 3, 6


@functools.lru_cache(maxsize=None)
def _regional_inputs(seed=4):
    rng = np.random.default_rng(seed)
    qobs = rng.uniform(0, 5, (C, T_REG))
    qobs[1, 60:] = np.nan                       # a record cut short
    qobs[2, rng.choice(T_REG, 12, replace=False)] = np.nan
    return dict(prec=rng.uniform(0, 15, (C, T_REG)),
                etp=rng.uniform(0, 4, (C, T_REG)), qobs=qobs,
                layers=(rng.uniform(0, 20, (C, T_REG, L)),
                        rng.uniform(-10, 12, (C, T_REG, L)),
                        rng.uniform(0, 1, (C, T_REG, L))),
                fi=rng.uniform(0, 0.5, (C, L)))


@pytest.fixture(scope="module")
def mesh2x4():
    return ensemble_catchment_mesh(2, 4, devices=['cpu'] * 8)


@pytest.mark.parametrize("engine", ["fused", "scan"])
@pytest.mark.parametrize("loss_metric", ["mse", "kge"])
def test_regional_gr4j_on_a_2d_mesh(mesh2x4, engine, loss_metric):
    d, params = _regional_inputs(), _gr4j_params(N, seed=9)
    series = interop.regional_forcing_from_numpy(
        d['prec'], d['etp'], d['qobs'], device='cpu', dtype=F64)
    got = regional_gr4j_objective(*series, 0.3, 0.3, _t(params),
                                  engine=engine, loss_metric=loss_metric,
                                  mesh=mesh2x4)
    plain = regional_gr4j_objective(*series, 0.3, 0.3, _t(params),
                                    engine=engine, loss_metric=loss_metric)
    want = jax_parallel.regional_gr4j_objective(
        d['prec'], d['etp'], d['qobs'], 0.3, 0.3,
        {k: jnp.asarray(v) for k, v in params.items()},
        mesh=jax_parallel.ensemble_catchment_mesh(ensemble=2, catchment=4),
        engine='xla', loss_metric=loss_metric)
    assert got.shape == (C, N)
    _close(got, plain)
    _close(got, want, rtol=1e-10)


@pytest.mark.parametrize("hyst,ice", [(False, False), (True, True)])
def test_regional_snow_on_a_2d_mesh(mesh2x4, hyst, ice):
    """The snow objective: per-catchment ``frac_ice`` split with its
    catchments; against the unsharded port and, in the widest variant
    (hysteresis, ice, statistics), JAX's 2-D mesh (its Pallas kernel in
    interpret mode, whose compile takes most of this test's time)."""
    d = _regional_inputs()
    rng = np.random.default_rng(2)
    names = ('CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4', 'DDF')
    bounds = ((0, 1), (0, 10), (1, 1000), (0, 1), (100, 1200), (-5, 3),
              (20, 300), (1.1, 2.9), (0, 30))
    params = _t({k: rng.uniform(lo, hi, N) for k, (lo, hi) in
                 zip(names, bounds)})
    etp, qobs, prec, temp, frac, *fi = interop.regional_forcing_from_numpy(
        d['etp'], d['qobs'], layers=d['layers'],
        frac_ice=d['fi'] if ice else None, device='cpu', dtype=F64)
    for loss_metric in ("mse", "kge"):
        args = (prec, temp, etp, frac, qobs, 2.0, -1.0, 0.2, 0.3, params)
        kw = dict(frac_ice=fi[0] if fi else None, hyst=hyst, ice=ice,
                  loss_metric=loss_metric, num_uh1=3, num_uh2=7)
        got = regional_snow_objective(*args, mesh=mesh2x4, **kw)
        _close(got, regional_snow_objective(*args, **kw))
    if hyst and ice:
        want = jax_parallel.regional_snow_objective(
            *d['layers'][:2], d['etp'], d['layers'][2], d['qobs'], 2.0, -1.0,
            0.2, 0.3, {k: jnp.asarray(v.numpy()) for k, v in params.items()},
            frac_ice=d['fi'], hyst=True, ice=True, loss_metric='kge',
            mesh=jax_parallel.ensemble_catchment_mesh(ensemble=2,
                                                      catchment=4),
            interpret=True, t_tile=8, num_uh1=3, num_uh2=7)
        _close(got, want, rtol=1e-10)


def test_regional_run_on_a_2d_mesh(mesh2x4):
    d, params = _regional_inputs(), _gr4j_params(N, seed=3)
    forcings = tuple(torch.as_tensor(d[k]) for k in ('prec', 'etp'))
    inits = (torch.full((C,), 0.1, dtype=F64),) * 2

    def kernel(prec, etp, s, r, params):
        return run_gr4j(prec, etp, s, r, params)

    got = regional_run(kernel, forcings + inits, _t(params), mesh=mesh2x4)
    plain = regional_run(kernel, forcings + inits, _t(params))
    want = jax_parallel.regional_run(
        lambda pr, et, s, r, p: jax_run_gr4j(pr, et, s, r, p),
        (d['prec'], d['etp'], np.full(C, 0.1), np.full(C, 0.1)),
        {k: jnp.asarray(v) for k, v in params.items()},
        mesh=jax_parallel.ensemble_catchment_mesh(ensemble=2, catchment=4))
    for g, p, w in zip(got, plain, want):
        assert g.shape == (C, N, T_REG)
        _close(g, p)
        _close(g, w)
    shared = regional_run(kernel, forcings + inits,
                          {k: float(v[0]) for k, v in params.items()},
                          mesh=mesh2x4)
    assert shared[0].shape == (C, T_REG)


def test_regional_sizes_the_mesh_does_not_divide_raise(mesh2x4):
    d, params = _regional_inputs(), _gr4j_params(5)
    series = interop.regional_forcing_from_numpy(
        d['prec'], d['etp'], d['qobs'], device='cpu', dtype=F64)
    with pytest.raises(ValueError, match="does not divide into the 2"):
        regional_gr4j_objective(*series, 0.3, 0.3, _t(params), mesh=mesh2x4)
    with pytest.raises(ValueError, match="does not divide into the 4"):
        regional_gr4j_objective(*(s[:3] for s in series), 0.3, 0.3,
                                _t(_gr4j_params(6)), mesh=mesh2x4)


# ---------------------------------------------------------------------------
# what raises under a mesh, as in JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CLASSES)
def test_fused_simulate_on_a_mesh_raises(name, mesh):
    kw = _class_inputs(name)
    model = getattr(models, name)(**CPU)
    with pytest.raises(ValueError, match="single-device"):
        model.simulate(**kw, engine='fused', mesh=mesh)
    if name not in ('ABCModel', 'Cemaneige'):       # fused forecast mode
        with pytest.raises(ValueError, match="sharded forecast"):
            model.simulate(**kw, engine='fused', mesh=mesh,
                           return_final_state=True)


@pytest.mark.parametrize("name", ('GR4J', 'HBVEdu', 'CemaneigeGR4J'))
def test_fused_statistics_on_a_mesh_raise(name, mesh):
    kw = _class_inputs(name)
    kw.pop('r_init', None)
    kw.pop('s_init', None)
    qobs = np.random.default_rng(0).uniform(0, 5, 40)
    with pytest.raises(ValueError, match="statistics path runs "
                                         "single-device"):
        monte_carlo(getattr(models, name)(**CPU), 8, qobs, mesh,
                    return_qsim=False, engine='fused', **kw)


def test_batched_sce_and_demc_on_a_mesh_raise(mesh):
    with pytest.raises(ValueError, match="per-point"):
        sce_ua(_quadratic_batched, BOUNDS4, batched=True, mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="per-point"):
        demc_sample(_quadratic_batched, BOUNDS4, batched=True, mesh=mesh,
                    **CPU)
    qobs, prec, etp = _gr4j_fit_case()
    with pytest.raises(ValueError, match="per-point"):
        models.GR4J(**CPU).fit(qobs, prec, etp, engine='fused',
                               method='sce', mesh=mesh)


def test_a_mesh_without_the_named_axis_raises(mesh):
    with pytest.raises(ValueError, match="no axis 'catchment'"):
        differential_evolution(_quadratic, BOUNDS4, mesh=mesh,
                               mesh_axis='catchment', **CPU)
    assert isinstance(mesh, Mesh)
