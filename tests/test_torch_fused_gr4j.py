"""PyTorch port, fused GR4J kernels' plain versions against JAX (CPU).

On CPU tensors each wrapper of ``rrmpg_tpu_torch.ops.fused_gr4j`` runs its
kernel's plain PyTorch version; these tests hold that version to the JAX
package: the XLA path (``run_gr4j`` + time mean) for every mode and UH
pair, and the Pallas kernels themselves in interpret mode at the tiny
size the JAX package's own non-slow test uses (N=100, T=130, t_tile=64).
Tolerance ``rtol=1e-10`` in float64: the same equations, summed in
another order.

The kernels themselves run only on an NVIDIA GPU; their tests are in
``tests/test_torch_cuda.py``.  Here we check that a CUDA request on a
machine without CUDA raises and nothing falls back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import run_gr4j as jax_run_gr4j
from rrmpg_tpu.ops.pallas_gr4j import (gr4j_ensemble_mse_pallas,
                                       gr4j_simulate_pallas)
from rrmpg_tpu_torch.interop import params_from_numpy
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import _build
from rrmpg_tpu_torch.ops import fused_gr4j as fg

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

RTOL = 1e-10
UH_CASES = [(3, 7, 2.9), (10, 21, 9.9)]


def _inputs(T, N, seed=0, x4_max=9.9, gaps=False):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::7] = np.nan
        qobs[20:35] = np.nan
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_max, N)}
    return prec, etp, qobs, params


def _p64(params):
    return params_from_numpy(params, device='cpu', dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _xla_qsim(n1, n2, x4_max):
    """JAX XLA trajectories of the shared XLA-comparison inputs (seed 4,
    T=200, N=48, s_init=0.4, r_init=0.3), computed once per UH pair."""
    prec, etp, _, params = _inputs(200, 48, seed=4, x4_max=x4_max)
    return np.asarray(jax.vmap(lambda p: jax_run_gr4j(
        prec, etp, 0.4, 0.3, p, n1, n2)[0])(
            {k: jnp.asarray(v) for k, v in params.items()}))


def test_traj_plain_matches_pallas_interpret():
    prec, etp, _, params = _inputs(130, 100, seed=2)
    want = gr4j_simulate_pallas(prec, etp, 0.2, 0.2, params, t_tile=64,
                                interpret=True)
    got = fg.gr4j_simulate_fused(_t(prec), _t(etp), 0.2, 0.2,
                                 _p64(params))
    assert got.shape == (100, 130)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)


def test_stats_plain_matches_pallas_interpret_masked():
    prec, etp, qobs, params = _inputs(130, 100, seed=2, gaps=True)
    want = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.2, 0.2, params,
                                    t_tile=64, interpret=True, stats=True,
                                    masked=True)
    got = fg.gr4j_ensemble_mse_fused(
        _t(prec), _t(etp), _t(qobs), 0.2, 0.2,
        _p64(params), stats=True,
        masked=True)
    assert got.shape == (4, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("n1,n2,x4_max", UH_CASES)
def test_traj_plain_matches_xla(n1, n2, x4_max):
    prec, etp, _, params = _inputs(200, 48, seed=4, x4_max=x4_max)
    want = _xla_qsim(n1, n2, x4_max)
    got = fg.gr4j_simulate_fused(_t(prec), _t(etp), 0.4, 0.3,
                                 _p64(params),
                                 n1, n2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("n1,n2,x4_max", UH_CASES)
def test_objective_plain_matches_xla(n1, n2, x4_max, stats, masked):
    prec, etp, qobs, params = _inputs(200, 48, seed=4, x4_max=x4_max,
                                      gaps=masked)
    qsim = _xla_qsim(n1, n2, x4_max)
    valid = np.isfinite(qobs)
    qo, q = qobs[valid], qsim[:, valid]
    want = np.stack([((q - qo) ** 2).mean(1), q.mean(1), (q * q).mean(1),
                     (q * qo).mean(1)])
    got = fg.gr4j_ensemble_mse_fused(
        _t(prec), _t(etp), _t(qobs), 0.4, 0.3,
        _p64(params), n1, n2,
        stats=stats, masked=masked)
    np.testing.assert_allclose(got.numpy(), want if stats else want[0],
                               rtol=RTOL)


def test_unsupported_uh_pair_names_supported_pairs():
    prec, etp, _, params = _inputs(20, 4)
    with pytest.raises(ValueError, match=r"\(3, 7\), \(10, 21\)"):
        fg.gr4j_simulate_fused(_t(prec), _t(etp), 0.0, 0.0,
                               _p64(params),
                               11, 23)


def test_all_nan_qobs_raises():
    """Divergence from rrmpg_tpu, chosen on purpose: JAX returns inf/NaN
    through T/n_valid for a record with no valid observation; the port
    raises."""
    prec, etp, _, params = _inputs(20, 4)
    with pytest.raises(ValueError, match="no finite value"):
        fg.gr4j_ensemble_mse_fused(
            _t(prec), _t(etp), _t(np.full(20, np.nan)), 0.0, 0.0,
            _p64(params), masked=True)


def test_warm_entry_not_ported_yet():
    """The name is from when ``state=`` was refused; it is ported now: the
    warm objective is the mean squared error of the warm trajectory
    (rtol 1e-12: the same plain steps, summed in time order), and a state
    whose history is too short for the registers raises."""
    prec, etp, qobs, params = _inputs(20, 4)
    p64 = _p64(params)
    _, state = fg.gr4j_simulate_state_fused(_t(prec), _t(etp), p64, None,
                                            0.4, 0.3)
    qsim, _ = fg.gr4j_simulate_state_fused(_t(prec), _t(etp), p64, state)
    got = fg.gr4j_ensemble_mse_fused(_t(prec), _t(etp), _t(qobs), 0.0, 0.0,
                                     p64, state=state)
    want = ((qsim - _t(qobs)) ** 2).mean(dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    short = state._replace(pr_history=state.pr_history[:, -6:])
    with pytest.raises(ValueError, match="holds 6 routing inputs"):
        fg.gr4j_ensemble_mse_fused(_t(prec), _t(etp), _t(qobs), 0.0, 0.0,
                                   p64, state=short)


def test_mixed_dtypes_and_foreign_devices_raise():
    prec, etp, qobs, params = _inputs(20, 4)
    p64 = _p64(params)
    with pytest.raises(ValueError, match="one device"):
        fg.gr4j_simulate_fused(_t(prec).float(), _t(etp).float(), 0.0, 0.0,
                               p64)
    meta = {k: v.to("meta") for k, v in p64.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fg.gr4j_simulate_fused(_t(prec).to("meta"), _t(etp).to("meta"),
                               0.0, 0.0, meta)


def test_cpu_runs_count_no_launches():
    prec, etp, qobs, params = _inputs(30, 4)
    fg.reset_launches()
    p64 = _p64(params)
    fg.gr4j_simulate_fused(_t(prec), _t(etp), 0.0, 0.0, p64)
    fg.gr4j_ensemble_mse_fused(_t(prec), _t(etp), _t(qobs), 0.0, 0.0, p64,
                               stats=True)
    assert {"gr4j_mse", "gr4j_stats", "gr4j_traj"} <= set(fg.LAUNCHES)
    assert not any(fg.LAUNCHES.values())


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        GR4J(device="cuda")
    # The kernel build raises instead of falling back when nvcc is absent.
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()
