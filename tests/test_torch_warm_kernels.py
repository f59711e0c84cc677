"""PyTorch port: the plain versions of the GR4J and HBV-Edu state kernels
(K4, K14) and of the warm objectives (K1/K2, K12) against the Pallas kernels.

Inputs come from a numpy seed and go through the Pallas kernel in interpret
mode (``interpret=True``, as ``tests/test_class_warm.py`` and
``tests/test_pallas_hbv.py`` run them on the CPU) and through the port's
wrapper on CPU tensors, where it runs its kernel's plain PyTorch version.
One state, produced by the JAX kernel, is handed to both packages
(``rrmpg_tpu_torch.interop``).  float64; trajectories, every state row and
the objectives agree to ``rtol=1e-9, atol=1e-11`` (the same steps in the
same order; XLA contracts multiply-adds here and there), and the plain
versions agree with the port's own sequential warm ops to ``1e-10``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.models.states import HBVEduState as JaxHBVEduState
from rrmpg_tpu.ops.pallas_gr4j import (gr4j_ensemble_mse_pallas,
                                       gr4j_simulate_pallas_state)
from rrmpg_tpu.ops.pallas_hbv import (hbv_ensemble_mse_pallas,
                                      hbv_simulate_pallas_state)
from rrmpg_tpu_torch.interop import params_from_numpy, state_from_numpy
from rrmpg_tpu_torch.models import HBVEdu
from rrmpg_tpu_torch.ops import fused_gr4j as fg
from rrmpg_tpu_torch.ops import fused_hbv as fh
from rrmpg_tpu_torch.ops import gr4j as ops_gr4j
from rrmpg_tpu_torch.ops import hbvedu as ops_hbv

F64 = torch.float64
KERNEL_TOL = dict(rtol=1e-9, atol=1e-11)
OPS_TOL = dict(rtol=1e-10, atol=1e-12)
UH = {"3/7": (3, 7, 2.9), "10/21": (10, 21, 9.9)}
T, SPLIT, N = 48, 29, 5


def _t(a):
    return torch.tensor(np.asarray(a, np.float64), dtype=F64)


def _gr4j_inputs(x4_max, T=T, seed=0, gaps=False):
    rng = np.random.default_rng(seed)
    prec, etp = rng.uniform(0, 15, T), rng.uniform(0, 4, T)
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::5] = np.nan
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_max, N)}
    return prec, etp, qobs, params


def _torch_gr4j_state(state):
    return state_from_numpy("GR4JState",
                            tuple(np.asarray(x) for x in state), 'cpu', F64)


def _assert_state_close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _pallas_gr4j(prec, etp, params, n1, n2, state=None, inits=(0.0, 0.0)):
    return gr4j_simulate_pallas_state(
        prec, etp, params, state, *inits, t_tile=8, num_uh1=n1, num_uh2=n2,
        interpret=True)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uh", sorted(UH))
def test_gr4j_state_plain_matches_pallas_cold_and_warm(uh):
    n1, n2, x4_max = UH[uh]
    prec, etp, _, params = _gr4j_inputs(x4_max)
    p64 = params_from_numpy(params, 'cpu', F64)
    want_q, want_st = _pallas_gr4j(prec[:SPLIT], etp[:SPLIT], params, n1, n2,
                                   inits=(0.4, 0.3))
    got_q, got_st = fg.gr4j_simulate_state_fused(
        _t(prec[:SPLIT]), _t(etp[:SPLIT]), p64, None, 0.4, 0.3, n1, n2)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **KERNEL_TOL)
    assert got_st.pr_history.shape == (N, n2 - 1)
    _assert_state_close(got_st, want_st, **KERNEL_TOL)
    # warm: both continue from the JAX kernel's state
    want_q2, want_st2 = _pallas_gr4j(prec[SPLIT:], etp[SPLIT:], params, n1,
                                     n2, state=want_st)
    got_q2, got_st2 = fg.gr4j_simulate_state_fused(
        _t(prec[SPLIT:]), _t(etp[SPLIT:]), p64, _torch_gr4j_state(want_st),
        num_uh1=n1, num_uh2=n2)
    np.testing.assert_allclose(got_q2.numpy(), np.asarray(want_q2),
                               **KERNEL_TOL)
    _assert_state_close(got_st2, want_st2, **KERNEL_TOL)
    # and the chain is the unbroken K3 run (split invariance)
    full = fg.gr4j_simulate_fused(_t(prec), _t(etp), 0.4, 0.3, p64, n1, n2)
    np.testing.assert_allclose(torch.cat([got_q, got_q2], 1).numpy(),
                               full.numpy(), **KERNEL_TOL)


@pytest.mark.parametrize("split", [1, 2, 5, 19, 40])
@pytest.mark.parametrize("uh", sorted(UH))
def test_gr4j_state_plain_matches_warm_op(uh, split):
    """Against the port's sequential ops, at split points shorter and
    longer than the history (H = 6 / 20)."""
    n1, n2, x4_max = UH[uh]
    prec, etp, _, params = _gr4j_inputs(x4_max, seed=1)
    p64 = params_from_numpy(params, 'cpu', F64)
    tp, te = _t(prec), _t(etp)
    q_a, _, _, st_a = ops_gr4j.run_gr4j(tp[:split], te[:split], 0.4, 0.3,
                                        p64, n1, n2, return_final=True)
    got_a, got_st_a = fg.gr4j_simulate_state_fused(tp[:split], te[:split],
                                                   p64, None, 0.4, 0.3, n1,
                                                   n2)
    np.testing.assert_allclose(got_a.numpy(), q_a.numpy(), **OPS_TOL)
    _assert_state_close(got_st_a, st_a, **OPS_TOL)
    q_b, _, _, st_b = ops_gr4j.run_gr4j_warm(tp[split:], te[split:], st_a,
                                             p64, n1, n2)
    got_b, got_st_b = fg.gr4j_simulate_state_fused(
        tp[split:], te[split:], p64, st_a, num_uh1=n1, num_uh2=n2)
    np.testing.assert_allclose(got_b.numpy(), q_b.numpy(), **OPS_TOL)
    _assert_state_close(got_st_b, st_b, **OPS_TOL)


@pytest.mark.parametrize("t_len", [1, 3])
def test_gr4j_segments_shorter_than_the_history_match_pallas(t_len):
    """A warm segment of fewer steps than H keeps the tail of the incoming
    history in front of its own routing inputs."""
    n1, n2, x4_max = UH["3/7"]
    prec, etp, _, params = _gr4j_inputs(x4_max, seed=2)
    p64 = params_from_numpy(params, 'cpu', F64)
    _, st = _pallas_gr4j(prec[:20], etp[:20], params, n1, n2,
                         inits=(0.5, 0.5))
    seg = slice(20, 20 + t_len)
    want_q, want_st = _pallas_gr4j(prec[seg], etp[seg], params, n1, n2,
                                   state=st)
    got_q, got_st = fg.gr4j_simulate_state_fused(
        _t(prec[seg]), _t(etp[seg]), p64, _torch_gr4j_state(st), num_uh1=n1,
        num_uh2=n2)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **KERNEL_TOL)
    _assert_state_close(got_st, want_st, **KERNEL_TOL)
    np.testing.assert_array_equal(
        got_st.pr_history[:, :6 - t_len].numpy(),
        np.asarray(st.pr_history)[:, t_len:])
    # cold and short: zeros in front
    cold_q, cold_st = fg.gr4j_simulate_state_fused(
        _t(prec[seg]), _t(etp[seg]), p64, None, 0.5, 0.5, n1, n2)
    want_cq, want_cst = _pallas_gr4j(prec[seg], etp[seg], params, n1, n2,
                                     inits=(0.5, 0.5))
    _assert_state_close(cold_st, want_cst, **KERNEL_TOL)
    assert float(cold_st.pr_history[:, :6 - t_len].abs().max()) == 0.0


def test_gr4j_long_history_enters_short_registers():
    """A 20-tap history (from a (10, 21) run) enters a (3, 7) kernel
    trimmed to its last 6 taps; the reverse raises."""
    prec, etp, _, params = _gr4j_inputs(2.9, seed=3)
    p64 = params_from_numpy(params, 'cpu', F64)
    _, st20 = _pallas_gr4j(prec[:SPLIT], etp[:SPLIT], params, 10, 21,
                           inits=(0.4, 0.3))
    want_q, want_st = _pallas_gr4j(prec[SPLIT:], etp[SPLIT:], params, 3, 7,
                                   state=st20)
    got_q, got_st = fg.gr4j_simulate_state_fused(
        _t(prec[SPLIT:]), _t(etp[SPLIT:]), p64, _torch_gr4j_state(st20),
        num_uh1=3, num_uh2=7)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **KERNEL_TOL)
    assert got_st.pr_history.shape == (N, 6)
    _assert_state_close(got_st, want_st, **KERNEL_TOL)
    with pytest.raises(ValueError, match="holds 6 routing inputs"):
        fg.gr4j_simulate_state_fused(_t(prec), _t(etp), p64, got_st,
                                     num_uh1=10, num_uh2=21)
    with pytest.raises(ValueError, match="T >= 1"):
        fg.gr4j_simulate_state_fused(_t(prec[:0]), _t(etp[:0]), p64)


# ---------------------------------------------------------------------------
# warm K1 / K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_gr4j_warm_objective_plain_matches_pallas(mode):
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    n1, n2, x4_max = UH["3/7"]
    prec, etp, qobs, params = _gr4j_inputs(x4_max, seed=4, gaps=masked)
    p64 = params_from_numpy(params, 'cpu', F64)
    _, st = _pallas_gr4j(prec[:SPLIT], etp[:SPLIT], params, n1, n2,
                         inits=(0.4, 0.3))
    tail = slice(SPLIT, T)
    want = gr4j_ensemble_mse_pallas(
        prec[tail], etp[tail], qobs[tail], 0.0, 0.0, params, t_tile=8,
        num_uh1=n1, num_uh2=n2, interpret=True, stats=stats, state=st,
        masked=masked)
    got = fg.gr4j_ensemble_mse_fused(
        _t(prec[tail]), _t(etp[tail]), _t(qobs[tail]), 0.0, 0.0, p64, n1, n2,
        stats=stats, masked=masked, state=_torch_gr4j_state(st))
    assert got.shape == ((4, N) if stats else (N,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # and it is the objective of K4's warm trajectory
    qsim, _ = fg.gr4j_simulate_state_fused(
        _t(prec[tail]), _t(etp[tail]), p64, _torch_gr4j_state(st),
        num_uh1=n1, num_uh2=n2)
    err = (qsim - _t(qobs[tail])) ** 2
    mse = torch.nanmean(err, dim=1) if masked else err.mean(dim=1)
    np.testing.assert_allclose((got[0] if stats else got).numpy(),
                               mse.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# K14 and warm K12
# ---------------------------------------------------------------------------

HBV_INITS = (2.0, 100.0, 3.0, 10.0)


def _hbv_inputs(seed=0, gaps=False, nan_members=True):
    rng = np.random.default_rng(seed)
    forcing = (rng.uniform(-8, 22, T), rng.uniform(0, 15, T),
               rng.integers(0, 12, T), rng.uniform(0.5, 4, 12),
               rng.uniform(-3, 18, 12))
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::5] = np.nan
    bounds = HBVEdu._default_bounds
    params = {k: rng.uniform(*bounds[k], N) for k in bounds}
    if nan_members:
        params['FC'][0] = 2.0     # empties the soil store: NaN from there on
    return forcing, qobs, params


def _hbv_cut(forcing, lo, hi):
    temp, prec, month, pe_m, t_m = forcing
    return temp[lo:hi], prec[lo:hi], month[lo:hi], pe_m, t_m


def _hbv_tensors(forcing):
    temp, prec, month, pe_m, t_m = forcing
    return _t(temp), _t(prec), torch.tensor(month), _t(pe_m), _t(t_m)


def _assert_close_nan_aware(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)],
                               **tol)


def test_hbv_state_plain_matches_pallas_cold_and_warm():
    forcing, _, params = _hbv_inputs()
    p64 = params_from_numpy(params, 'cpu', F64)
    head, tail = _hbv_cut(forcing, 0, SPLIT), _hbv_cut(forcing, SPLIT, T)
    want_q, want_st = hbv_simulate_pallas_state(
        *head, *HBV_INITS, params, t_tile=8, interpret=True)
    got_q, got_st = fh.hbv_simulate_state_fused(*_hbv_tensors(head),
                                                *HBV_INITS, p64)
    assert bool(np.isnan(np.asarray(want_st.soil)).any())
    _assert_close_nan_aware(got_q, want_q, **KERNEL_TOL)
    for g, w in zip(got_st, want_st):
        _assert_close_nan_aware(g, w, **KERNEL_TOL)
    # warm from the JAX kernel's state; NaN members stay NaN in both
    want_q2, want_st2 = hbv_simulate_pallas_state(
        *tail, 0.0, 0.0, 0.0, 0.0, params, t_tile=8, interpret=True,
        state=want_st)
    state = state_from_numpy("HBVEduState",
                             tuple(np.asarray(x) for x in want_st), 'cpu',
                             F64)
    got_q2, got_st2 = fh.hbv_simulate_state_fused(
        *_hbv_tensors(tail), 0.0, 0.0, 0.0, 0.0, p64, state=state)
    _assert_close_nan_aware(got_q2, want_q2, **KERNEL_TOL)
    for g, w in zip(got_st2, want_st2):
        _assert_close_nan_aware(g, w, **KERNEL_TOL)
    # the chain is the unbroken K13 run
    full = fh.hbv_simulate_fused(*_hbv_tensors(forcing), *HBV_INITS, p64)
    _assert_close_nan_aware(torch.cat([got_q, got_q2], 1), full,
                            **KERNEL_TOL)


@pytest.mark.parametrize("split", [1, 2, 30])
def test_hbv_state_plain_matches_warm_op(split):
    forcing, _, params = _hbv_inputs(seed=1, nan_members=False)
    p64 = params_from_numpy(params, 'cpu', F64)
    head = _hbv_tensors(_hbv_cut(forcing, 0, split))
    tail = _hbv_tensors(_hbv_cut(forcing, split, T))
    *series, fin = ops_hbv.run_hbvedu(*head, *HBV_INITS, p64,
                                      return_final=True)
    got_q, got_st = fh.hbv_simulate_state_fused(*head, *HBV_INITS, p64)
    np.testing.assert_allclose(got_q.numpy(), series[0].numpy(), **OPS_TOL)
    _assert_state_close(got_st, fin, **OPS_TOL)
    *series2, fin2 = ops_hbv.run_hbvedu_warm(*tail, fin, p64)
    got_q2, got_st2 = fh.hbv_simulate_state_fused(*tail, 0, 0, 0, 0, p64,
                                                  state=got_st)
    np.testing.assert_allclose(got_q2.numpy(), series2[0].numpy(), **OPS_TOL)
    _assert_state_close(got_st2, fin2, **OPS_TOL)


@pytest.mark.parametrize("mode", ["mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_hbv_warm_objective_plain_matches_pallas(mode):
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    forcing, qobs, params = _hbv_inputs(seed=2, gaps=masked)
    p64 = params_from_numpy(params, 'cpu', F64)
    rng = np.random.default_rng(3)
    leaves = tuple(rng.uniform(lo, hi, N) for lo, hi in
                   ((0, 20), (60, 150), (0, 8), (0, 20)))
    want = hbv_ensemble_mse_pallas(
        *forcing, qobs, 0.0, 0.0, 0.0, 0.0, params, t_tile=8, interpret=True,
        stats=stats, masked=masked,
        state=JaxHBVEduState(*(jnp.asarray(x) for x in leaves)))
    got = fh.hbv_ensemble_mse_fused(
        *_hbv_tensors(forcing), _t(qobs), 0.0, 0.0, 0.0, 0.0, p64,
        stats=stats, masked=masked,
        state=state_from_numpy("HBVEduState", leaves, 'cpu', F64))
    assert got.shape == ((4, N) if stats else (N,))
    _assert_close_nan_aware(got, want, **KERNEL_TOL)
    # one state shared by all members: scalars in place of (N,) leaves
    shared = tuple(float(x[1]) for x in leaves)
    got_shared = fh.hbv_ensemble_mse_fused(
        *_hbv_tensors(forcing), _t(qobs), 0.0, 0.0, 0.0, 0.0, p64,
        stats=stats, masked=masked, state=shared)
    np.testing.assert_array_equal(got_shared[..., 1].numpy(),
                                  got[..., 1].numpy())

