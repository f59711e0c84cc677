"""PyTorch port: the plain versions of the snow-family state kernel (K10) and
of the warm objective (K8) against the Pallas kernels.

As ``tests/test_torch_warm_kernels.py``: inputs from a numpy seed, the Pallas
kernel in interpret mode, the port's wrapper on CPU tensors (its kernel's
plain PyTorch version), one state -- produced by the JAX kernel -- handed to
both.  All four variants (plain, hysteresis, ice, hysteresis + ice) at one
and three elevation layers, and hysteresis + ice at five.  float64; trajectories, every state row and the
objectives agree to ``rtol=1e-9, atol=1e-11``, the plain version agrees with
the port's sequential warm compositions to ``1e-10``, and the layer
constants of the original series pass through a continuation unchanged.
"""

import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import pallas_snow as jax_snow
from rrmpg_tpu_torch.interop import (layer_forcing_from_numpy,
                                     params_from_numpy, state_from_numpy)
from rrmpg_tpu_torch.models import states
from rrmpg_tpu_torch.ops import compositions, fused_snow

F64 = torch.float64
KERNEL_TOL = dict(rtol=1e-9, atol=1e-11)
OPS_TOL = dict(rtol=1e-10, atol=1e-12)
VARIANTS = {"plain": (False, False), "hyst": (True, False),
            "ice": (False, True), "hyst+ice": (True, True)}
T, SPLIT, N = 40, 23, 4
INITS = dict(snow_pack_init=2.0, thermal_state_init=-1.0, s_init=0.4,
             r_init=0.3)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64), dtype=F64)


class _Case:
    """One set of inputs, as numpy for JAX and as tensors for the port."""

    def __init__(self, L, x4_max=2.9, seed=0, gaps=False):
        rng = np.random.default_rng(seed)
        self.layers = (rng.uniform(0, 15, (T, L)),
                       rng.uniform(-12, 18, (T, L)),
                       np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
        self.etp = rng.uniform(0, 4, T)
        self.frac_ice = rng.uniform(0, 0.7, L)
        self.qobs = rng.uniform(0, 5, T)
        if gaps:
            self.qobs[::5] = np.nan
        self.params = {
            'CTG': rng.uniform(0, 1, N), 'Kf': rng.uniform(0, 10, N),
            'Thacc': rng.uniform(1, 100, N), 'Rsp': rng.uniform(0, 1, N),
            'x1': rng.uniform(10, 1200, N), 'x2': rng.uniform(-5, 3, N),
            'x3': rng.uniform(20, 5000, N),
            'x4': rng.uniform(1.1, x4_max, N), 'DDF': rng.uniform(0, 30, N)}
        self.t_params = params_from_numpy(self.params, 'cpu', F64)

    def cut(self, lo, hi):
        """(JAX args, torch args) of the segment: prec, temp, etp, frac."""
        prec, temp, frac = (a[lo:hi] for a in self.layers)
        t_prec, t_temp, t_frac = layer_forcing_from_numpy(prec, temp, frac,
                                                          device='cpu',
                                                          dtype=F64)
        return ((prec, temp, self.etp[lo:hi], frac),
                (t_prec, t_temp, _t(self.etp[lo:hi]), t_frac))

    def kw(self, variant, uh=(3, 7)):
        hyst, ice = VARIANTS[variant]
        jax_kw = dict(frac_ice=self.frac_ice if ice else None, hyst=hyst,
                      ice=ice, num_uh1=uh[0], num_uh2=uh[1])
        torch_kw = dict(jax_kw, frac_ice=_t(self.frac_ice) if ice else None)
        return jax_kw, torch_kw


def _to_torch(state):
    """A JAX SnowGR4JState as the port's bundle."""
    return state_from_numpy(
        "SnowGR4JState",
        ((type(state.snow).__name__,
          tuple(np.asarray(x) for x in state.snow)),
         tuple(np.asarray(x) for x in state.gr4j)), 'cpu', F64)


def _leaves(state):
    return [np.asarray(x) for x in (*state.snow, *state.gr4j)]


def _assert_state_close(got, want, **tol):
    assert type(got.snow).__name__ == type(want.snow).__name__
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


def _pallas_state(args, params, state=None, **kw):
    inits = INITS if state is None else {}
    return jax_snow.snowgr4j_simulate_pallas_state(
        *args, params, state=state, t_tile=8, interpret=True, **inits, **kw)


# Every variant at one and three layers, and hysteresis + ice at five, the
# layer count whose states the CUDA kernel keeps in registers.
STATE_CASES = [(variant, L) for L in (1, 3) for variant in sorted(VARIANTS)]
STATE_CASES.append(("hyst+ice", 5))


@pytest.mark.parametrize("variant,L", STATE_CASES)
def test_snow_state_plain_matches_pallas_cold_and_warm(variant, L):
    case = _Case(L, seed=L)
    jax_kw, torch_kw = case.kw(variant)
    (j_head, t_head), (j_tail, t_tail) = case.cut(0, SPLIT), case.cut(SPLIT,
                                                                      T)
    want_q, want_st = _pallas_state(j_head, case.params, **jax_kw)
    got_q, got_st = fused_snow.snowgr4j_simulate_state_fused(
        *t_head, case.t_params, None, **INITS, **torch_kw)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **KERNEL_TOL)
    _assert_state_close(got_st, want_st, **KERNEL_TOL)
    # cold + state exit is K9's run
    plain_q = fused_snow.snowgr4j_simulate_fused(
        *t_head, *INITS.values(), case.t_params, **torch_kw)
    assert torch.equal(got_q, plain_q)
    # warm: both continue from the JAX kernel's state
    want_q2, want_st2 = _pallas_state(j_tail, case.params, state=want_st,
                                      **jax_kw)
    got_q2, got_st2 = fused_snow.snowgr4j_simulate_state_fused(
        *t_tail, case.t_params, _to_torch(want_st), **torch_kw)
    np.testing.assert_allclose(got_q2.numpy(), np.asarray(want_q2),
                               **KERNEL_TOL)
    _assert_state_close(got_st2, want_st2, **KERNEL_TOL)
    # the constants of the ORIGINAL series pass through unchanged
    np.testing.assert_array_equal(np.asarray(got_st2.snow[-1]),
                                  np.asarray(want_st.snow[-1]))


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_snow_state_plain_matches_warm_compositions(variant, L):
    """Against the port's sequential warm ops, and one hop against two."""
    hyst, ice = VARIANTS[variant]
    case = _Case(L, x4_max=9.9, seed=10 + L)
    _, torch_kw = case.kw(variant, uh=(10, 21))
    (_, t_head), (_, t_tail) = case.cut(0, SPLIT), case.cut(SPLIT, T)
    _, st = fused_snow.snowgr4j_simulate_state_fused(
        *t_head, case.t_params, None, **INITS, **torch_kw)
    one_q, one_st = fused_snow.snowgr4j_simulate_state_fused(
        *t_tail, case.t_params, st, **torch_kw)
    sg = st.snow
    prec, temp, etp, frac = t_tail
    if hyst:
        out = compositions.run_cemaneigehystgr4j_warm(
            prec, temp, etp, frac,
            ((sg.g, sg.etg, sg.sca, sg.swe_max), st.gr4j), sg.psol_annual,
            case.t_params, frac_ice=torch_kw['frac_ice'])
    else:
        out = compositions.run_cemaneigegr4j_warm(
            prec, temp, etp, frac, ((sg.g, sg.etg), st.gr4j), sg.g_thresh,
            case.t_params, frac_ice=torch_kw['frac_ice'])
    np.testing.assert_allclose(one_q.numpy(), out[0].numpy(), **OPS_TOL)
    snow_carry, gr4j_final = out[-1]
    for g, w in zip(one_st.snow[:-1], snow_carry):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **OPS_TOL)
    for g, w in zip(one_st.gr4j, gr4j_final):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **OPS_TOL)
    # two hops, the first shorter than the history (3 < H = 20)
    (_, t_mid), (_, t_rest) = (case.cut(SPLIT, SPLIT + 3),
                               case.cut(SPLIT + 3, T))
    q1, st1 = fused_snow.snowgr4j_simulate_state_fused(
        *t_mid, case.t_params, st, **torch_kw)
    q2, st2 = fused_snow.snowgr4j_simulate_state_fused(
        *t_rest, case.t_params, st1, **torch_kw)
    np.testing.assert_allclose(torch.cat([q1, q2], 1).numpy(),
                               one_q.numpy(), **OPS_TOL)
    for g, w in zip(_leaves(st2), _leaves(one_st)):
        np.testing.assert_allclose(g, w, **OPS_TOL)
    # the snow rows are the same operations: equal, not close
    for g, w in zip(st2.snow, one_st.snow):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", ["plain", "hyst+ice"])
def test_snow_short_segment_and_long_history_match_pallas(variant):
    """A 2-step warm segment (shorter than H = 6) from a state whose
    history has 20 taps (a (10, 21) run) entering a (3, 7) kernel."""
    case = _Case(2, seed=20)
    jax_kw21, _ = case.kw(variant, uh=(10, 21))
    jax_kw, torch_kw = case.kw(variant)
    (j_head, _), (j_seg, t_seg) = case.cut(0, SPLIT), case.cut(SPLIT,
                                                               SPLIT + 2)
    _, st20 = _pallas_state(j_head, case.params, **jax_kw21)
    assert np.asarray(st20.gr4j.pr_history).shape == (N, 20)
    want_q, want_st = _pallas_state(j_seg, case.params, state=st20, **jax_kw)
    got_q, got_st = fused_snow.snowgr4j_simulate_state_fused(
        *t_seg, case.t_params, _to_torch(st20), **torch_kw)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **KERNEL_TOL)
    _assert_state_close(got_st, want_st, **KERNEL_TOL)
    assert got_st.gr4j.pr_history.shape == (N, 6)
    np.testing.assert_array_equal(
        got_st.gr4j.pr_history[:, :4].numpy(),
        np.asarray(st20.gr4j.pr_history)[:, -4:])


@pytest.mark.parametrize("mode", ["mse", "stats+masked"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_snow_warm_objective_plain_matches_pallas(variant, mode):
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    case = _Case(2, seed=30, gaps=masked)
    jax_kw, torch_kw = case.kw(variant)
    (j_head, _), (j_tail, t_tail) = case.cut(0, SPLIT), case.cut(SPLIT, T)
    _, st = _pallas_state(j_head, case.params, **jax_kw)
    qobs = case.qobs[SPLIT:]
    want = jax_snow.snowgr4j_ensemble_mse_pallas(
        *j_tail, qobs, 0.0, 0.0, 0.0, 0.0, case.params, t_tile=8,
        interpret=True, stats=stats, masked=masked, state=st, **jax_kw)
    got = fused_snow.snowgr4j_ensemble_mse_fused(
        *t_tail, _t(qobs), 0.0, 0.0, 0.0, 0.0, case.t_params, stats=stats,
        masked=masked, state=_to_torch(st), **torch_kw)
    assert got.shape == ((4, N) if stats else (N,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # and it is the objective of K10's warm trajectory
    qsim, _ = fused_snow.snowgr4j_simulate_state_fused(
        *t_tail, case.t_params, _to_torch(st), **torch_kw)
    err = (qsim - _t(qobs)) ** 2
    mse = torch.nanmean(err, dim=1) if masked else err.mean(dim=1)
    np.testing.assert_allclose((got[0] if stats else got).numpy(),
                               mse.numpy(), rtol=1e-12)


def test_warm_entry_guards():
    case = _Case(2, seed=40)
    _, torch_kw = case.kw("hyst")
    (_, t_head) = case.cut(0, SPLIT)
    _, st = fused_snow.snowgr4j_simulate_state_fused(
        *t_head, case.t_params, None, **INITS, **torch_kw)
    ndsi = _t(np.random.default_rng(0).uniform(0, 100, (2, SPLIT)))
    with pytest.raises(ValueError, match="mse/stats objectives"):
        fused_snow.snowgr4j_ensemble_mse_fused(
            *t_head, _t(case.qobs[:SPLIT]), 0.0, 0.0, 0.0, 0.0,
            case.t_params, ndsi=ndsi, sca_stats=True, state=st, **torch_kw)
    with pytest.raises(ValueError, match="start cold"):
        fused_snow.snowgr4j_ensemble_mse_fused(
            *t_head, _t(case.qobs[:SPLIT]), 0.0, 0.0, 0.0, 0.0,
            case.t_params, snow_only=True, state=st)
    wrong_layers = st._replace(snow=states.map_state(
        lambda x: x[:, :1], st.snow))
    with pytest.raises(ValueError, match=r"must be \(N, 2\)"):
        fused_snow.snowgr4j_simulate_state_fused(
            *t_head, case.t_params, wrong_layers, **torch_kw)
    short = st._replace(gr4j=st.gr4j._replace(
        pr_history=st.gr4j.pr_history[:, -3:]))
    with pytest.raises(ValueError, match="holds 3 routing inputs"):
        fused_snow.snowgr4j_simulate_state_fused(
            *t_head, case.t_params, short, **torch_kw)
