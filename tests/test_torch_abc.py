"""PyTorch port, the ABC slice against the JAX package (CPU, float64).

The same numpy inputs go through ``rrmpg_tpu`` and ``rrmpg_tpu_torch``:

* ops (``run_abcmodel``, ``run_abcmodel_pscan``, ``run_abcmodel_warm``)
  against ``rrmpg_tpu.ops.abc``, ``rtol=1e-10``: the same recurrence,
  summed in another order by the parallel-prefix forms;
* the fused kernels' module (on CPU tensors the wrappers run the plain
  version) against the Pallas kernels in interpret mode, ``rtol=1e-9``,
  including the edges c = 0 and c = 1;
* ``ABCModel`` (``simulate`` on both engines, sampler, validation, ``fit``)
  and ``monte_carlo`` against the JAX classes.  DE trajectories cannot
  match (JAX and torch draw different random numbers), so calibration is
  checked through the objective at JAX's optimum.

Every model is built with ``device='cpu'``; the kernels themselves are
tested on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.ops import abc as jax_abc
from rrmpg_tpu.ops.pallas_linear_scan import (abc_fused_pallas,
                                              abc_fused_single_pallas)
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch.interop import params_from_numpy
from rrmpg_tpu_torch.models import ABCModel
from rrmpg_tpu_torch.ops import abc, fused_abc
from rrmpg_tpu_torch.ops._launch import LAUNCHES, reset_launches
from rrmpg_tpu_torch.tools import monte_carlo

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
OPS_TOL = dict(rtol=1e-10, atol=1e-12)
KERNEL_TOL = dict(rtol=1e-9, atol=1e-12)
LOSSES = ('mse', 'rmse', 'nse', 'kge')


def _prec(T, seed=0):
    return np.random.default_rng(seed).uniform(0, 20, T)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _model():
    return ABCModel(device='cpu', dtype=F64)


def _assert_pair(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("c", [0.0, 0.12, 1.0])
@pytest.mark.parametrize("fn", ["run_abcmodel", "run_abcmodel_pscan"])
def test_ops_match_jax(fn, c):
    prec = _prec(700, seed=1)
    params = {'a': 0.3, 'b': 0.4, 'c': c}
    want = jax_abc.run_abcmodel(prec, 5.0, params)
    got = getattr(abc, fn)(_t(prec), 5.0, params)
    assert got[0].shape == (700,)
    assert got[1][0].item() == 5.0 and got[0][0].item() == 0.0
    _assert_pair(got, want, OPS_TOL)


def test_ops_batched_members_match_jax_members():
    """A leading member axis gives what JAX gives member by member; JAX's
    own pscan engine agrees too."""
    prec = _prec(300, seed=2)
    np.random.seed(3)
    raw = jax_models.ABCModel().get_random_params(num=6)
    params = params_from_numpy(raw, device='cpu', dtype=F64)
    s0 = _t(np.linspace(0, 5, 6))
    for fn in (abc.run_abcmodel, abc.run_abcmodel_pscan):
        q, s = fn(_t(prec), s0, params)
        assert q.shape == s.shape == (6, 300)
        for i in range(6):
            member = {k: raw[k][i] for k in 'abc'}
            _assert_pair((q[i], s[i]), jax_abc.run_abcmodel_pscan(
                prec, float(s0[i]), member), OPS_TOL)


@pytest.mark.parametrize("T", [1, 2, 5])
def test_ops_short_series(T):
    prec = _prec(T, seed=T)
    params = {'a': 0.3, 'b': 0.4, 'c': 0.2}
    want = abc.run_abcmodel(_t(prec), 2.0, params)
    _assert_pair(abc.run_abcmodel_pscan(_t(prec), 2.0, params), want,
                 OPS_TOL)
    _assert_pair(fused_abc.abc_fused_single(_t(prec), 2.0, params), want,
                 OPS_TOL)


def test_warm_matches_jax_and_chains():
    prec = _prec(400, seed=4)
    params = {'a': 0.25, 'b': 0.35, 'c': 0.2}
    want = jax_abc.run_abcmodel_warm(prec, 3.0, params)
    got = abc.run_abcmodel_warm(_t(prec), 3.0, params)
    _assert_pair(got, want, OPS_TOL)
    # Splitting anywhere and carrying the storage reproduces the whole.
    q_a, s_a, carry = abc.run_abcmodel_warm(_t(prec[:150]), 3.0, params)
    q_b, s_b, final = abc.run_abcmodel_warm(_t(prec[150:]), carry, params)
    np.testing.assert_allclose(torch.cat([q_a, q_b]).numpy(),
                               got[0].numpy(), **OPS_TOL)
    assert final.item() == pytest.approx(got[2].item(), rel=1e-12)


@pytest.mark.parametrize("T,c", [(1000, 0.12), (1000, 0.0), (1000, 1.0),
                                 (40000, 0.12), (40000, 0.0), (40000, 1.0)])
@pytest.mark.parametrize("kernel", ["abc_fused", "abc_fused_single"])
def test_kernel_module_matches_pallas_interpret(kernel, T, c):
    prec = _prec(T, seed=T)
    params = {'a': 0.3, 'b': 0.4, 'c': c}
    pallas = (abc_fused_pallas if kernel == "abc_fused"
              else abc_fused_single_pallas)
    want = pallas(prec, 5.0, params, rows=128, interpret=True)
    reset_launches()
    got = getattr(fused_abc, kernel)(_t(prec), 5.0, params)
    assert LAUNCHES[kernel] == 0          # CPU tensors: the plain version
    _assert_pair(got, want, KERNEL_TOL)


def test_kernel_module_input_checks():
    prec = _t(_prec(20))
    params = {'a': 0.3, 'b': 0.4, 'c': 0.2}
    with pytest.raises(TypeError, match="float32 or float64"):
        fused_abc.abc_fused(prec.to(torch.float16), 0.0, params)
    with pytest.raises(ValueError, match=r"\(T,\)"):
        fused_abc.abc_fused_single(prec[None, :], 0.0, params)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_abc.abc_fused_single(prec.to("meta"), 0.0, params)
    with pytest.raises(ValueError, match="one device"):
        abc.run_abcmodel(prec, 0.0, dict(params, a=torch.ones(2,
                                                               device="meta")))


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_simulate_matches_jax(engine):
    prec = _prec(500, seed=5)
    np.random.seed(7)
    params = jax_models.ABCModel().get_random_params(num=9)
    q_want, s_want = jax_models.ABCModel().simulate(
        prec, initial_state=1.5, params=params, return_storage=True)
    q, s = _model().simulate(prec, initial_state=1.5, params=params,
                             return_storage=True, engine=engine)
    assert q.shape == s.shape == (500, 9)
    _assert_pair((q, s), (q_want, s_want), OPS_TOL)
    single = _model().simulate(prec, engine=engine)
    assert single.shape == (500, 1)


def test_sampler_constraint_and_seed_parity():
    np.random.seed(11)
    want = jax_models.ABCModel().get_random_params(num=500)
    np.random.seed(11)
    got = _model().get_random_params(num=500)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == jax_models.ABCModel().get_dtype()
    assert (got['b'] <= 1 - got['a']).all()
    tensors = params_from_numpy(want, device='cpu', dtype=F64)
    assert set(tensors) == {'a', 'b', 'c'}
    np.testing.assert_array_equal(tensors['b'].numpy(), want['b'])


def test_simulate_errors():
    prec = _prec(30)
    model = _model()
    with pytest.raises(ValueError, match="non-negative"):
        model.simulate(-prec)
    with pytest.raises(TypeError, match="initial_state"):
        model.simulate(prec, initial_state=-1)
    with pytest.raises(TypeError, match="return_storage"):
        model.simulate(prec, return_storage=1)
    with pytest.raises(ValueError, match="engine"):
        model.simulate(prec, engine='pallas')
    qsim, state = model.simulate(prec, return_final_state=True)
    assert type(state).__name__ == "ABCState" and state.storage.shape == (1,)
    with pytest.raises(TypeError, match="must be a ABCState"):
        model.simulate(prec, initial_state=object())
    with pytest.raises(TypeError, match="must be a ABCState"):
        model.fit(prec, prec, initial_state=object())
    with pytest.raises(ValueError, match="engine='scan' only"):
        model.simulate(prec, initial_state=state, engine='fused')
    with pytest.raises(ValueError, match="loss_metric"):
        model.fit(prec, prec, loss_metric='mae')


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("gaps", [False, True])
def test_monte_carlo_matches_jax(engine, gaps):
    """Same np.random.seed -> same ensemble and metrics, rtol=1e-8.  ABC has
    no fused statistics kernel: both engines take the trajectory branch."""
    prec = _prec(200, seed=6)
    qobs = np.random.default_rng(6).uniform(0, 12, 200)
    if gaps:
        qobs[::9] = np.nan
    metric_names = ('mse', 'nse', 'kge')
    np.random.seed(13)
    want = jax_monte_carlo(jax_models.ABCModel(), num=40, qobs=qobs,
                           prec=prec, metrics=metric_names)
    np.random.seed(13)
    got = monte_carlo(_model(), num=40, qobs=qobs, prec=prec,
                      metrics=metric_names, engine=engine)
    np.testing.assert_array_equal(got['params'], want['params'])
    np.testing.assert_allclose(got['qsim'], np.asarray(want['qsim']),
                               **OPS_TOL)
    for m in metric_names:
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-8,
                                   err_msg=m)


def _objective(model, qobs, prec, loss_metric):
    return model._batch_objective(_t(qobs), _t(prec), 0.0, loss_metric)


def test_fit_objective_at_jax_optimum():
    prec = _prec(150, seed=8)
    qobs = np.asarray(jax_models.ABCModel(
        params={'a': 0.4, 'b': 0.3, 'c': 0.25}).simulate(prec)).ravel()
    jres = jax_models.ABCModel().fit(qobs, prec, seed=0, maxiter=3)
    model = _model()
    objective = _objective(model, qobs, prec, 'mse')
    x = torch.tensor(np.asarray(jres.x))[None, :]
    assert objective(x).item() == pytest.approx(jres.fun, rel=1e-8, abs=1e-14)


@pytest.mark.parametrize("loss_metric", LOSSES)
def test_fit_every_loss(loss_metric):
    """``fit`` gives a finite loss inside the bounds, and its objective
    equals JAX's calibration loss on the same candidates, gaps included."""
    prec = _prec(150, seed=9)
    qobs = np.random.default_rng(9).uniform(0, 12, 150)
    qobs[::8] = np.nan
    model = _model()
    res = model.fit(qobs, prec, loss_metric=loss_metric, seed=0, maxiter=3)
    assert np.isfinite(res.fun) and res.nit <= 3
    assert res.population.shape == (45, 3)
    assert ((0 <= res.x) & (res.x <= 1)).all()

    np.random.seed(3)
    params = jax_models.ABCModel().get_random_params(num=6)
    qsim = np.asarray(jax_models.ABCModel().simulate(prec, params=params))
    loss = jax_metrics.calibration_loss(loss_metric)
    want = np.array([float(loss(qobs, qsim[:, i])) for i in range(6)])
    X = torch.tensor(np.stack([params[n] for n in 'abc'], 1))
    np.testing.assert_allclose(
        _objective(model, qobs, prec, loss_metric)(X).numpy(), want,
        rtol=1e-8)
