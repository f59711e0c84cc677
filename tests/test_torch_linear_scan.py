"""PyTorch port, the Toeplitz linear scan and ABC's ``'scan'`` engine on it
(CPU), against the JAX package.

* ``ops.linear_recurrence`` against ``rrmpg_tpu.ops.linear_recurrence``
  at n in {0, 1, 127, 128, 129, 16385} with ``chunk=128`` and n = 1000
  with ``chunk=4`` (three levels of recursion), alpha in {0, 0.5,
  1 - 7e-5, 1}, s0 in {0, 3.7}, float64, ``rtol=1e-12``; per-member alpha
  (the member axis that stands in for ``vmap``) against JAX member by
  member, also when the members go through in groups; a ``b`` that is
  not a tensor goes to the card unless the CPU is asked for.
* ``run_abcmodel_matscan`` / ``run_abcmodel_warm`` against JAX's in
  float64 at ``rtol=1e-12`` (the port builds the powers from ``c``,
  JAX from ``1 - c``: the same numbers to ~1e-15), and the sequential
  ``run_abcmodel`` at ``rtol=1e-10``.
* In float32 both within ABC's tolerance (1e-4 of the series' largest
  value) of JAX's float32 run at ordinary ``c`` and of the float64
  doubling scan, also at c = 7e-5, where JAX's float32 form (a rounded
  ``1 - c``) drifts 3.4e-4 of the storage's largest value over 131072
  steps and the port's 2.2e-7.
* The products never use TF32: a float32 scan multiplies float64
  operands and rounds once (on the card, ``chip_smoke.py`` phase
  ``surface`` holds a run under ``set_float32_matmul_precision('high')``
  equal to one under ``'highest'``).
* ``ABCModel(device='cpu')`` on ``'scan'`` (cold ``simulate``, warm
  ``simulate``, ``fit``) against JAX's ``ABCModel`` on ``'xla'``: the
  trajectories at ``rtol=1e-12``; a fit's ``fun`` equals JAX's MSE at its
  ``x`` (DE's random streams differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.models.states import ABCState as JaxABCState
from rrmpg_tpu.ops import abc as jax_abc
from rrmpg_tpu.ops import linear_recurrence as jax_linear_recurrence
from rrmpg_tpu_torch.models import ABCModel
from rrmpg_tpu_torch.models.states import ABCState
from rrmpg_tpu_torch.ops import abc, linear_recurrence, linear_scan

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F32, F64 = torch.float32, torch.float64
RTOL = 1e-12
ABC_RTOL_OF_MAX_F32 = 1e-4


def _series(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 5, n)


@pytest.mark.parametrize("s0", [0.0, 3.7])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1 - 7e-5, 1.0])
@pytest.mark.parametrize("n, chunk", [(0, 128), (1, 128), (127, 128),
                                      (128, 128), (129, 128), (16385, 128),
                                      (1000, 4)])
def test_linear_recurrence_matches_jax(n, chunk, alpha, s0):
    b = _series(n)
    got = linear_recurrence(alpha, torch.as_tensor(b), s0, chunk=chunk)
    want = np.asarray(jax_linear_recurrence(alpha, jnp.asarray(b), s0,
                                            chunk=chunk))
    assert got.shape == want.shape == (n,) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0.0)


def test_linear_recurrence_per_member_alpha_is_jax_member_by_member():
    alpha = np.array([0.0, 0.3, 1 - 7e-5, 1.0])
    s0 = np.array([1.0, -2.0, 3.7, 0.5])
    b = np.stack([_series(300, seed) for seed in range(4)])
    got = linear_recurrence(torch.as_tensor(alpha), torch.as_tensor(b),
                            torch.as_tensor(s0), chunk=16)
    shared = linear_recurrence(torch.as_tensor(alpha),
                               torch.as_tensor(b[1]), 0.0, chunk=16)
    assert got.shape == shared.shape == (4, 300)
    for k in range(4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(
            jax_linear_recurrence(alpha[k], jnp.asarray(b[k]), s0[k],
                                  chunk=16)), rtol=RTOL, atol=0.0)
        np.testing.assert_allclose(shared[k].numpy(), np.asarray(
            jax_linear_recurrence(alpha[k], jnp.asarray(b[1]), 0.0,
                                  chunk=16)), rtol=RTOL, atol=0.0)


def test_linear_recurrence_puts_other_input_on_the_card(monkeypatch):
    """A ``b`` that is not a tensor goes to ``config.DEFAULT_DEVICE`` (the
    card), as every entry point of the port that takes numpy does: without
    CUDA it raises unless the caller asks for the CPU, where it runs in
    ``config.default_float()``; a tensor stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        linear_recurrence(0.5, np.ones(3), 0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        linear_recurrence(0.5, [1.0, 1.0, 1.0], 0.0)
    got = linear_recurrence(0.5, np.ones(3), 0.0, device='cpu')
    assert got.device.type == 'cpu' and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), [1.0, 1.5, 1.75], rtol=0)
    on_cpu = linear_recurrence(0.5, torch.ones(3, dtype=F64), 0.0)
    assert on_cpu.device.type == 'cpu' and on_cpu.dtype == F64


def test_members_in_groups_equal_one_group(monkeypatch):
    """Past ``MATRIX_ELEMENTS // chunk**2`` members the scan runs in groups
    of members (each level's matrices bounded); small groups give the one
    group's result, and JAX's member by member, through
    ``linear_recurrence`` and the ABC scans alike."""
    alpha = np.array([0.0, 0.3, 1 - 7e-5, 1.0, 0.9])
    s0 = np.array([1.0, -2.0, 3.7, 0.5, 0.0])
    b = np.stack([_series(300, seed) for seed in range(5)])
    prec = _series(300, 7) * 4
    params = {'a': torch.full((5,), 0.3, dtype=F64),
              'b': torch.full((5,), 0.2, dtype=F64),
              'c': torch.as_tensor(1 - alpha)}

    def run():
        return (linear_recurrence(torch.as_tensor(alpha), torch.as_tensor(b),
                                  torch.as_tensor(s0), chunk=4),
                *abc.run_abcmodel_matscan(torch.as_tensor(prec),
                                          torch.as_tensor(s0), params),
                *abc.run_abcmodel_warm(torch.as_tensor(prec),
                                       torch.as_tensor(s0), params)[:2])

    whole = run()
    # groups of 2 members at chunk 4, of 1 at the ABC scans' 128
    monkeypatch.setattr(linear_scan, "MATRIX_ELEMENTS", 2 * 4 * 4)
    grouped = run()
    for g, w in zip(grouped, whole):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=1e-300)
    for k in range(5):
        np.testing.assert_allclose(grouped[0][k].numpy(), np.asarray(
            jax_linear_recurrence(alpha[k], jnp.asarray(b[k]), s0[k],
                                  chunk=4)), rtol=RTOL, atol=0.0)


def test_float32_products_run_in_float64(monkeypatch):
    """Every product of a float32 scan multiplies float64 operands, so that
    no TF32 or other reduced precision of the process can enter (JAX asks
    for ``Precision.HIGHEST``); a float64 scan multiplies as it is."""
    seen = []
    real = torch.matmul

    def spy(x, y):
        seen.append((x.dtype, y.dtype))
        return real(x, y)

    monkeypatch.setattr(linear_scan.torch, "matmul", spy)
    for dtype in (F32, F64):
        q, s = abc.run_abcmodel_matscan(
            torch.as_tensor(_series(1000), dtype=dtype), 0.0,
            {'a': 0.3, 'b': 0.2, 'c': 0.1})
        assert q.dtype == s.dtype == dtype
    # per scan: the chunks, then their starts
    assert seen == [(F64, F64)] * 4


C_VALUES = [0.0, 7e-5, 0.12, 0.9, 1.0, 1.5]   # 1.5: a negative 1 - c


def _params(c):
    return {'a': 0.3, 'b': 0.2, 'c': c}


@pytest.mark.parametrize("c", C_VALUES)
def test_matscan_and_warm_match_jax(c):
    prec = _series(3000, 1) * 4
    got = abc.run_abcmodel_matscan(torch.as_tensor(prec), 2.0, _params(c))
    want = jax_abc.run_abcmodel_matscan(jnp.asarray(prec), 2.0, _params(c))
    sequential = abc.run_abcmodel(torch.as_tensor(prec), 2.0, _params(c))
    for g, w, s in zip(got, want, sequential):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-300)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-10,
                                   atol=1e-12)
    got = abc.run_abcmodel_warm(torch.as_tensor(prec), 2.0, _params(c))
    want = jax_abc.run_abcmodel_warm(jnp.asarray(prec), 2.0, _params(c))
    assert got[2].shape == ()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-300)


def test_matscan_members_match_jax_per_member():
    prec = _series(700, 2) * 4
    rng = np.random.default_rng(3)
    params = {'a': rng.uniform(0, 0.5, 6), 'b': rng.uniform(0, 0.5, 6),
              'c': np.array([0.0, 7e-5, 0.05, 0.5, 0.999, 1.0])}
    s0 = rng.uniform(0, 10, 6)
    got = abc.run_abcmodel_matscan(
        torch.as_tensor(prec), torch.as_tensor(s0),
        {k: torch.as_tensor(v) for k, v in params.items()})
    warm = abc.run_abcmodel_warm(
        torch.as_tensor(prec), torch.as_tensor(s0),
        {k: torch.as_tensor(v) for k, v in params.items()})
    assert got[0].shape == warm[0].shape == (6, 700)
    for k in range(6):
        p = {n: v[k] for n, v in params.items()}
        want = jax_abc.run_abcmodel_matscan(jnp.asarray(prec), s0[k], p)
        want_warm = jax_abc.run_abcmodel_warm(jnp.asarray(prec), s0[k], p)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=1e-300)
        for g, w in zip(warm, want_warm):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=1e-300)


def _within_abc_tol(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= ABC_RTOL_OF_MAX_F32 * np.abs(want).max(), err


@pytest.mark.parametrize("c", [0.05, 0.3, 0.9])
def test_float32_within_abc_tolerance_of_jax_and_float64(c):
    prec = _series(20000, 4) * 4
    got = abc.run_abcmodel_matscan(torch.as_tensor(prec, dtype=F32), 0.0,
                                   _params(c))
    jax32 = jax_abc.run_abcmodel_matscan(jnp.asarray(prec, jnp.float32),
                                         0.0, _params(c))
    f64 = abc.run_abcmodel_pscan(torch.as_tensor(prec), 0.0, _params(c))
    warm = abc.run_abcmodel_warm(torch.as_tensor(prec, dtype=F32), 0.0,
                                 _params(c))
    warm64 = abc.run_abcmodel_warm(torch.as_tensor(prec), 0.0, _params(c))
    for g, j, w in zip(got, jax32, f64):
        assert g.dtype == F32
        _within_abc_tol(g.numpy(), j)
        _within_abc_tol(g.numpy(), w.numpy())
    for g, w in zip(warm, warm64):
        _within_abc_tol(g.numpy(), w.numpy())


def test_float32_small_c_within_abc_tolerance_of_float64():
    """A member at c = 7e-5 over 131072 steps (the storage ~1/c): the
    powers from ``c`` keep float32 within ABC's tolerance of the float64
    doubling scan, where a rounded ``1 - c`` does not."""
    prec = np.random.default_rng(0).uniform(0, 20, 131072)
    params = {'a': torch.tensor([0.3, 0.3]), 'b': torch.tensor([0.2, 0.2]),
              'c': torch.tensor([7e-5, 0.12])}
    got = abc.run_abcmodel_matscan(torch.as_tensor(prec, dtype=F32), 0.0,
                                   {k: v.float() for k, v in params.items()})
    want = abc.run_abcmodel_pscan(torch.as_tensor(prec), 0.0,
                                  {k: v.double() for k, v in params.items()})
    for g, w in zip(got, want):
        for k in range(2):
            _within_abc_tol(g[k].numpy(), w[k].numpy())
    # The storage's drift over its largest value: 2.220e-7 with the
    # powers from c, 3.436e-4 with JAX's rounded 1 - c (the CPU, float32).
    largest = want[1][0].abs().max()
    drift = (got[1][0].double() - want[1][0]).abs().max() / largest
    assert drift < 1e-6
    rounded = linear_recurrence(torch.tensor(1.0) - 7e-5,
                                0.3 * torch.as_tensor(prec[1:], dtype=F32),
                                0.0)
    drift = (rounded.double() - want[1][0, 1:]).abs().max() / largest
    assert drift > ABC_RTOL_OF_MAX_F32


# ---------------------------------------------------------------------------
# the class on the 'scan' engine
# ---------------------------------------------------------------------------

def _class_params():
    np.random.seed(9)
    return jax_models.ABCModel().get_random_params(num=5)


def test_class_simulate_scan_matches_jax_xla():
    prec = _series(2000, 5) * 4
    params = _class_params()
    model = ABCModel(device='cpu', dtype=F64)
    q, s, state = model.simulate(prec, initial_state=1.5, params=params,
                                 return_storage=True,
                                 return_final_state=True)
    want_q, want_s, want_state = jax_models.ABCModel().simulate(
        prec, initial_state=1.5, params=params, return_storage=True,
        return_final_state=True)
    for g, w in ((q, want_q), (s, want_s),
                 (state.storage, want_state.storage)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-300)
    warm = model.simulate(prec[:300], initial_state=state, params=params)
    want = jax_models.ABCModel().simulate(
        prec[:300], initial_state=JaxABCState(
            storage=jnp.asarray(state.storage.numpy())), params=params)
    np.testing.assert_allclose(warm.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("warm", [False, True])
def test_class_fit_fun_is_jax_mse_at_x(warm):
    prec = _series(400, 6) * 4
    truth = ABCModel(params={'a': 0.4, 'b': 0.1, 'c': 0.05}, device='cpu',
                     dtype=F64)
    qobs = truth.simulate(prec).numpy()[:, 0].copy()
    qobs[::9] = np.nan
    init = (ABCState(storage=torch.tensor(4.0, dtype=F64)) if warm
            else 0.0)
    res = ABCModel(device='cpu', dtype=F64).fit(qobs, prec,
                                                initial_state=init, seed=2,
                                                maxiter=30)
    jax_init = (JaxABCState(storage=jnp.asarray([4.0])) if warm else 0.0)
    q = np.asarray(jax_models.ABCModel(params=dict(zip('abc', res.x))
                                       ).simulate(prec,
                                                  initial_state=jax_init))
    assert res.fun == pytest.approx(np.nanmean((q[:, 0] - qobs) ** 2),
                                    rel=RTOL)
    assert res.fun < 0.05 * np.nanvar(qobs)
