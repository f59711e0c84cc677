"""PyTorch port: class-level forecast mode against ``rrmpg_tpu``.

Mirrors ``tests/test_class_warm.py`` and ``tests/test_warm_state.py`` for
all eight classes of the port on both engines (``'scan'`` = plain sequential
PyTorch, ``'fused'`` = the kernels' plain versions on the CPU): the same
inputs, made from a numpy seed, go through ``simulate(...,
return_final_state=True)`` / ``simulate(initial_state=)`` /
``fit(initial_state=)`` of the JAX classes (``engine='xla'``) and of the
port's.  float64 on the CPU.  Tolerances: trajectories and state leaves
against JAX ``rtol=1e-9, atol=1e-11`` (the same operations; XLA contracts
and reassociates here and there), split invariance inside the port
``rtol=1e-10``; two optimisers of different packages are held to the truth
they recover, not to each other.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.models import states as jax_states
from rrmpg_tpu.ops.gr4j import GR4JState as JaxGR4JState
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.interop import state_to_numpy
from rrmpg_tpu_torch.models import states
from rrmpg_tpu_torch.tools import monte_carlo

F64 = torch.float64
DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
JAX_TOL = dict(rtol=1e-9, atol=1e-11)
SPLIT_TOL = dict(rtol=1e-10, atol=1e-12)
T, SPLIT = 120, 70
ALTS = [550, 620, 700, 785, 920]
FRAC_ICE = [0.02, 0.04, 0.25, 0.51, 0.71]
SNOW_KW = dict(met_station_height=495, altitudes=ALTS)
SNOW_ARGS = ('prec', 'mean_temp', 'min_temp', 'max_temp')

# class -> (positional forcing, extra keywords, cold-start keywords, engines
# that carry state)
SPEC = {
    'GR4J': (('prec', 'etp'), {}, dict(s_init=0.3, r_init=0.5),
             ('scan', 'fused')),
    'HBVEdu': (('mean_temp', 'prec', 'month', 'pe_m', 't_m'), {},
               dict(snow_init=2., soil_init=100., s1_init=1., s2_init=1.),
               ('scan', 'fused')),
    'ABCModel': (('prec',), {}, dict(initial_state=5.0), ('scan',)),
    'Cemaneige': (SNOW_ARGS, SNOW_KW,
                  dict(snow_pack_init=1.5, thermal_state_init=-0.5),
                  ('scan',)),
    'CemaneigeGR4J': (SNOW_ARGS + ('etp',), SNOW_KW,
                      dict(snow_pack_init=1.5, thermal_state_init=-0.5,
                           s_init=0.4, r_init=0.3), ('scan', 'fused')),
    'CemaneigeGR4JIce': (SNOW_ARGS + ('etp',),
                         dict(SNOW_KW, frac_ice=FRAC_ICE),
                         dict(snow_pack_init=1.5, thermal_state_init=-0.5,
                              s_init=0.4, r_init=0.3), ('scan', 'fused')),
    'CemaneigeHystGR4J': (SNOW_ARGS + ('etp',), SNOW_KW,
                          dict(snow_pack_init=1.5, thermal_state_init=-0.5,
                               sca_init=0.2, s_init=0.4, r_init=0.3),
                          ('scan', 'fused')),
    'CemaneigeHystGR4JIce': (SNOW_ARGS + ('etp',),
                             dict(SNOW_KW, frac_ice=FRAC_ICE),
                             dict(snow_pack_init=1.5,
                                  thermal_state_init=-0.5, sca_init=0.2,
                                  s_init=0.4, r_init=0.3),
                             ('scan', 'fused')),
}
ALL = sorted(SPEC)
COMPOSITIONS = [n for n in ALL if n.startswith('Cemaneige') and 'GR4J' in n]
CASES = [(n, e) for n in ALL for e in SPEC[n][3]]
# Classes whose warm chain equals the unbroken cold run (the snow classes
# compute a constant from the series they are given).
EXACT = [(n, e) for n, e in CASES if not n.startswith('Cemaneige')]
N_SERIES = {'GR4J': 3, 'HBVEdu': 5, 'ABCModel': 2, 'Cemaneige': 3,
            'CemaneigeGR4J': 5, 'CemaneigeGR4JIce': 6,
            'CemaneigeHystGR4J': 7, 'CemaneigeHystGR4JIce': 9}
STORAGE_KW = {n: ('return_storages' if n == 'Cemaneige' else
                  'return_storage') for n in ALL}


@pytest.fixture(scope="module")
def forcing():
    rng = np.random.default_rng(42)
    mt = rng.uniform(-10, 15, T)
    return {'prec': rng.uniform(0, 15, T), 'mean_temp': mt,
            'min_temp': mt - rng.uniform(0, 5, T),
            'max_temp': mt + rng.uniform(0, 5, T),
            'etp': rng.uniform(0, 4, T), 'month': rng.integers(1, 13, T),
            'pe_m': rng.uniform(1, 4, 12), 't_m': rng.uniform(-5, 15, 12)}


def _params(name, num, seed=0):
    np.random.seed(seed)
    return getattr(models, name)(device='cpu').get_random_params(num)


def _param_dict(name, seed):
    record = _params(name, 1, seed)[0]
    return {k: float(record[k]) for k in record.dtype.names}


def _model(name, **kw):
    return getattr(models, name)(device='cpu', dtype=F64, **kw)


def _call_args(name, forcing, lo, hi):
    return tuple(forcing[k][lo:hi] if len(forcing[k]) == T else forcing[k]
                 for k in SPEC[name][0])


def _sim(model, name, forcing, lo, hi, state=None, **kw):
    """``simulate`` over [lo, hi): cold with the class's init scalars, or
    warm from ``state``.  Works for the classes of either package."""
    _, extra, cold, _ = SPEC[name]
    start = dict(cold) if state is None else dict(initial_state=state)
    return model.simulate(*_call_args(name, forcing, lo, hi), **extra,
                          **start, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(state):
    if type(state).__name__ == "SnowGR4JState":
        return _leaves(state.snow) + _leaves(state.gr4j)
    return [_np(x) for x in state]


def _to_jax(state):
    name, leaves = state_to_numpy(state)
    if name == "SnowGR4JState":
        (snow_name, snow_leaves), gr4j_leaves = leaves
        return jax_states.SnowGR4JState(
            snow=getattr(jax_states, snow_name)(*snow_leaves),
            gr4j=JaxGR4JState(*gr4j_leaves))
    cls = JaxGR4JState if name == "GR4JState" else getattr(jax_states, name)
    return cls(*leaves)


def _assert_states_close(got, want, **tol):
    assert type(got).__name__ == type(want).__name__
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# Split invariance, final states, hand-off between engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 7, SPLIT])
@pytest.mark.parametrize("name,engine", EXACT)
def test_split_matches_unbroken(forcing, name, engine, split):
    """Cold prefix (+ final state) -> warm continuation == unbroken run, at
    split points shorter and longer than the UH history."""
    model = _model(name)
    params = _params(name, 3)
    full = _sim(model, name, forcing, 0, T, params=params, engine=engine)
    q_a, state = _sim(model, name, forcing, 0, split, params=params,
                      engine=engine, return_final_state=True)
    q_b, state_b = _sim(model, name, forcing, split, T, state=state,
                        params=params, engine=engine,
                        return_final_state=True)
    assert q_a.shape == (split, 3) and q_b.shape == (T - split, 3)
    np.testing.assert_allclose(torch.cat([q_a, q_b]).numpy(), full.numpy(),
                               **SPLIT_TOL)
    _, state_full = _sim(model, name, forcing, 0, T, params=params,
                         engine=engine, return_final_state=True)
    _assert_states_close(state_b, state_full, **SPLIT_TOL)


@pytest.mark.parametrize("name,engine", CASES)
def test_final_state_and_continuation_match_jax(forcing, name, engine):
    """Cold final state equal to the JAX class's leaf for leaf; then both
    packages continue from that one state."""
    params = _params(name, 3, seed=1)
    model, jax_model = _model(name), getattr(jax_models, name)()
    q_a, state = _sim(model, name, forcing, 0, SPLIT, params=params,
                      engine=engine, return_final_state=True)
    want_q, want_state = _sim(jax_model, name, forcing, 0, SPLIT,
                              params=params, return_final_state=True)
    np.testing.assert_allclose(q_a.numpy(), np.asarray(want_q), **JAX_TOL)
    _assert_states_close(state, want_state, **JAX_TOL)
    assert all(x.shape[0] == 3 for x in _leaves(state))
    q_b, state_b = _sim(model, name, forcing, SPLIT, T, state=state,
                        params=params, engine=engine,
                        return_final_state=True)
    want_qb, want_state_b = _sim(jax_model, name, forcing, SPLIT, T,
                                 state=_to_jax(state), params=params,
                                 return_final_state=True)
    np.testing.assert_allclose(q_b.numpy(), np.asarray(want_qb), **JAX_TOL)
    _assert_states_close(state_b, want_state_b, **JAX_TOL)


@pytest.mark.parametrize("name", [n for n in ALL if 'Cemaneige' in n])
def test_snow_warm_chain_with_storages(forcing, name):
    """The snow classes carry a constant of the original series, so a warm
    chain is held against the one-hop continuation: every series, and the
    storages against JAX."""
    model, jax_model = _model(name), getattr(jax_models, name)()
    storage = {STORAGE_KW[name]: True, 'params': _params(name, 2, seed=9)}
    *series, state = _sim(model, name, forcing, 0, SPLIT,
                          return_final_state=True, **storage)
    assert len(series) == N_SERIES[name]
    plain = _sim(model, name, forcing, 0, SPLIT, **storage)
    for a, b in zip(series, plain):       # the state exit changes nothing
        assert torch.equal(a, b)
    one = _sim(model, name, forcing, SPLIT, T, state=state, **storage)
    mid = SPLIT + 4
    *hop1, st_mid = _sim(model, name, forcing, SPLIT, mid, state=state,
                         return_final_state=True, **storage)
    hop2 = _sim(model, name, forcing, mid, T, state=st_mid, **storage)
    want = _sim(jax_model, name, forcing, SPLIT, T, state=_to_jax(state),
                **storage)
    assert len(one) == len(want) == N_SERIES[name]
    for full, a, b, w in zip(one, hop1, hop2, want):
        np.testing.assert_allclose(full.numpy(), torch.cat([a, b]).numpy(),
                                   **SPLIT_TOL)
        assert full.shape == np.asarray(w).shape
        np.testing.assert_allclose(full.numpy(), np.asarray(w), **JAX_TOL)


@pytest.mark.parametrize("name", ['GR4J', 'HBVEdu'] + COMPOSITIONS)
def test_cross_engine_handoff(forcing, name):
    """A state made on one engine continues on the other."""
    model = _model(name)
    params = _params(name, 3, seed=2)
    finals = {}
    for engine in ('scan', 'fused'):
        _, finals[engine] = _sim(model, name, forcing, 0, SPLIT,
                                 params=params, engine=engine,
                                 return_final_state=True)
    _assert_states_close(finals['fused'], finals['scan'], **SPLIT_TOL)
    runs = [_sim(model, name, forcing, SPLIT, T, state=finals[made],
                 params=params, engine=used)
            for made, used in (('scan', 'scan'), ('scan', 'fused'),
                               ('fused', 'scan'), ('fused', 'fused'))]
    for other in runs[1:]:
        np.testing.assert_allclose(other.numpy(), runs[0].numpy(),
                                   **SPLIT_TOL)


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,engine", [('GR4J', 'scan'), ('GR4J', 'fused'),
                                         ('CemaneigeGR4J', 'scan'),
                                         ('CemaneigeHystGR4JIce', 'fused'),
                                         ('HBVEdu', 'fused'),
                                         ('ABCModel', 'scan')])
def test_shared_state_broadcasts_to_batch(forcing, name, engine):
    """One unbatched / 1-member state seeds an N-member ensemble: member i
    equals a single run of its parameters from that state."""
    model = _model(name)
    _, state = _sim(model, name, forcing, 0, SPLIT, return_final_state=True)
    assert all(x.shape[0] == 1 for x in _leaves(state))
    params = _params(name, 4, seed=3)
    q = _sim(model, name, forcing, SPLIT, T, state=state, params=params,
             engine=engine)
    assert q.shape == (T - SPLIT, 4)
    unbatched = states.map_state(lambda x: x[0], state)
    q_u = _sim(model, name, forcing, SPLIT, T, state=unbatched,
               params=params, engine=engine)
    assert torch.equal(q, q_u)
    single = _sim(model, name, forcing, SPLIT, T, state=state,
                  params=params[2:3], engine=engine)
    np.testing.assert_allclose(q[:, 2:3].numpy(), single.numpy(),
                               **SPLIT_TOL)


@pytest.mark.parametrize("engine", ['scan', 'fused'])
def test_gr4j_batched_states_match_members(forcing, engine):
    model = _model('GR4J')
    params = _params('GR4J', 3, seed=4)
    _, state = _sim(model, 'GR4J', forcing, 0, SPLIT, params=params,
                    engine=engine, return_final_state=True)
    assert state.s.shape == (3,) and state.pr_history.shape == (3, 20)
    for i in range(3):
        _, st_i = _sim(model, 'GR4J', forcing, 0, SPLIT,
                       params=params[i:i + 1], engine=engine,
                       return_final_state=True)
        np.testing.assert_allclose(state.s[i].numpy(), st_i.s[0].numpy(),
                                   **SPLIT_TOL)
        np.testing.assert_allclose(state.pr_history[i].numpy(),
                                   st_i.pr_history[0].numpy(), **SPLIT_TOL)


@pytest.mark.parametrize("engine", ['scan', 'fused'])
def test_monte_carlo_composes_with_initial_state(forcing, engine):
    """monte_carlo forwards simulate keywords, so an ensemble forecast from
    one carried state just works; the trajectory-free statistics path
    takes no state and says so, as the reference's does."""
    truth = _model('GR4J', params={'x1': 320., 'x2': 1.1, 'x3': 90.,
                                   'x4': 2.3})
    q_full, st = truth.simulate(forcing['prec'], forcing['etp'],
                                return_final_state=True)
    qobs = q_full.numpy()[SPLIT:, 0]
    np.random.seed(5)
    mc = monte_carlo(_model('GR4J'), 16, qobs=qobs,
                     prec=forcing['prec'][SPLIT:],
                     etp=forcing['etp'][SPLIT:], initial_state=st,
                     engine=engine)
    assert mc['qsim'].shape == (T - SPLIT, 16)
    assert np.isfinite(mc['mse']).all()
    np.random.seed(5)
    want = jax_models  # the same draw, the same state, through rrmpg_tpu
    from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
    mc_jax = jax_monte_carlo(want.GR4J(), 16, qobs=qobs,
                             prec=forcing['prec'][SPLIT:],
                             etp=forcing['etp'][SPLIT:],
                             initial_state=_to_jax(st))
    np.testing.assert_allclose(mc['qsim'], mc_jax['qsim'], **JAX_TOL)
    with pytest.raises(ValueError, match="Unused simulate kwargs"):
        monte_carlo(_model('GR4J'), 16, qobs=qobs, return_qsim=False,
                    prec=forcing['prec'][SPLIT:],
                    etp=forcing['etp'][SPLIT:], initial_state=st,
                    engine='fused')


# ---------------------------------------------------------------------------
# Recalibration from a state
# ---------------------------------------------------------------------------

def _truth_segment(name, forcing, truth_params):
    """(single-member state at SPLIT, the truth's discharge after it)."""
    truth = _model(name, params=truth_params)
    _, state = _sim(truth, name, forcing, 0, SPLIT, return_final_state=True)
    q_seg = _sim(truth, name, forcing, SPLIT, T, state=state)
    return state, q_seg.numpy()[:, 0]


def _fit(model, name, qobs, forcing, state=None, **kw):
    _, extra, cold, _ = SPEC[name]
    start = {} if state is None else dict(initial_state=state)
    return model.fit(qobs, *_call_args(name, forcing, SPLIT, T), **extra,
                     **start, **kw)


@pytest.mark.parametrize("engine", ['scan', 'fused'])
def test_gr4j_fit_from_state_recovers_truth(forcing, engine):
    """Calibrating a continuation segment from the true carried state
    finds (near-)zero loss, which a cold fit of the same segment cannot
    (its empty-history assumption is wrong)."""
    state, qobs = _truth_segment('GR4J', forcing,
                                 {'x1': 320., 'x2': 1.1, 'x3': 90.,
                                  'x4': 2.3})
    model = _model('GR4J')
    warm = _fit(model, 'GR4J', qobs, forcing, state, seed=0, maxiter=40,
                engine=engine)
    cold = _fit(model, 'GR4J', qobs, forcing, seed=0, maxiter=40,
                engine=engine)
    assert warm.fun < 1e-3 and warm.fun < cold.fun
    jax_fit = jax_models.GR4J().fit(
        qobs, *_call_args('GR4J', forcing, SPLIT, T),
        initial_state=_to_jax(state), seed=0, maxiter=40)
    assert jax_fit.fun < 1e-3


@pytest.mark.parametrize("metric", ['mse', 'rmse', 'nse', 'kge'])
@pytest.mark.parametrize("name", ['GR4J', 'HBVEdu', 'CemaneigeGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_warm_fit_fused_agrees_with_scan(forcing, name, metric):
    """The two engines' warm objectives agree to rounding, so same-seed DE
    runs land on matching optima (the reference's criterion: rtol 1e-3)."""
    state, qobs = _truth_segment(name, forcing, _param_dict(name, 6))
    qobs = qobs.copy()
    qobs[3::17] = np.nan                         # gaps: the masked kernels
    model = _model(name)
    fits = [_fit(model, name, qobs, forcing, state, seed=1, maxiter=4,
                 loss_metric=metric, engine=engine)
            for engine in ('scan', 'fused')]
    assert np.isfinite(fits[0].fun)
    np.testing.assert_allclose(fits[1].fun, fits[0].fun, rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("name", ['ABCModel', 'Cemaneige'])
def test_sequential_only_classes_fit_from_state(forcing, name):
    truth = {'ABCModel': {'a': 0.3, 'b': 0.2, 'c': 0.15},
             'Cemaneige': {'CTG': 0.25, 'Kf': 3.74}}[name]
    state, qobs = _truth_segment(name, forcing, truth)
    res = _fit(_model(name), name, qobs, forcing, state, seed=0, maxiter=30)
    assert res.fun < 1e-4
    if name == 'Cemaneige':
        with pytest.raises(ValueError, match="engine='scan' only"):
            _fit(_model(name), name, qobs, forcing, state, engine='fused')


@pytest.mark.parametrize("name", ['CemaneigeHystGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_fit_q_sca_from_state(forcing, name):
    """Q+SCA calibration from a state: 'scan' only, the objective at the
    truth is the reference's weighting of zero discharge error and the SCA
    misfit."""
    model = _model(name)
    state, qobs = _truth_segment(name, forcing, _param_dict(name, 7))
    rng = np.random.default_rng(8)
    ndsi = [rng.uniform(0, 100, T - SPLIT) for _ in range(5)]
    _, extra, _, _ = SPEC[name]
    args = _call_args(name, forcing, SPLIT, T)
    frac = (extra['frac_ice'],) if 'frac_ice' in extra else ()
    res = model.fit_Q_SCA(qobs, *args, *frac, *ndsi, **SNOW_KW,
                          initial_state=state, seed=0, maxiter=2)
    assert np.isfinite(res.fun)
    jax_res = getattr(jax_models, name)().fit_Q_SCA(
        qobs, *args, *frac, *ndsi, **SNOW_KW, initial_state=_to_jax(state),
        seed=0, maxiter=2)
    assert np.isfinite(jax_res.fun)
    with pytest.raises(ValueError, match="supports engine='scan'"):
        model.fit_Q_SCA(qobs, *args, *frac, *ndsi, **SNOW_KW,
                        initial_state=state, engine='fused')


# ---------------------------------------------------------------------------
# Guard rails: the reference's errors, in its words
# ---------------------------------------------------------------------------

def _error(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("name", ALL)
def test_wrong_state_type_message_matches_jax(forcing, name):
    wrong_t = (states.HBVEduState(*(np.zeros(1),) * 4) if name != 'HBVEdu'
               else states.ABCState(np.zeros(1)))
    wrong_j = _to_jax(wrong_t)
    got = _error(_sim, _model(name), name, forcing, 0, 30, state=wrong_t)
    want = _error(_sim, getattr(jax_models, name)(), name, forcing, 0, 30,
                  state=wrong_j)
    assert got == want and got[0] is TypeError


def test_wrong_snow_half_message_matches_jax(forcing):
    def plain(pkg, gr4j_cls):
        return pkg.SnowGR4JState(
            snow=pkg.CemaneigeState(*(np.zeros((1, 5)),) * 3),
            gr4j=gr4j_cls(np.zeros(1), np.zeros(1), np.zeros((1, 20))))
    name = 'CemaneigeHystGR4J'
    got = _error(_sim, _model(name), name, forcing, 0, 30,
                 state=plain(states, states.GR4JState))
    want = _error(_sim, jax_models.CemaneigeHystGR4J(), name, forcing, 0, 30,
                  state=plain(jax_states, JaxGR4JState))
    assert got == want and "CemaneigeHystState" in got[1]


@pytest.mark.parametrize("name", [n for n in ALL if n != 'ABCModel'])
def test_state_plus_cold_inits_message_matches_jax(forcing, name):
    """(ABC's ``initial_state`` is the state or the scalar: no conflict.)"""
    model, jax_model = _model(name), getattr(jax_models, name)()
    _, state = _sim(model, name, forcing, 0, 30, return_final_state=True)
    _, extra, cold, _ = SPEC[name]
    args = _call_args(name, forcing, 30, 60)
    got = _error(model.simulate, *args, **extra, **cold, initial_state=state)
    want = _error(jax_model.simulate, *args, **extra, **cold,
                  initial_state=_to_jax(state))
    assert got == want and "not both" in got[1]
    got = _error(model.fit, np.ones(30), *args, **extra, **cold,
                 initial_state=state)
    want = _error(jax_model.fit, np.ones(30), *args, **extra, **cold,
                  initial_state=_to_jax(state))
    assert got == want and "not both" in got[1]


def test_member_count_and_layer_mismatch_messages_match_jax(forcing):
    model, jax_model = _model('GR4J'), jax_models.GR4J()
    _, state3 = _sim(model, 'GR4J', forcing, 0, 30,
                     params=_params('GR4J', 3), return_final_state=True)
    kw = dict(params=_params('GR4J', 2, seed=1))
    got = _error(_sim, model, 'GR4J', forcing, 30, 60, state=state3, **kw)
    want = _error(_sim, jax_model, 'GR4J', forcing, 30, 60,
                  state=_to_jax(state3), **kw)
    assert got == want and "leading state axis" in got[1]
    got = _error(model.fit, np.ones(30),
                 *_call_args('GR4J', forcing, 30, 60), initial_state=state3)
    assert got[0] is ValueError and "one initial condition" in got[1]

    for name in ('Cemaneige', 'CemaneigeHystGR4JIce'):
        model, jax_model = _model(name), getattr(jax_models, name)()
        _, state = _sim(model, name, forcing, 0, 30,
                        return_final_state=True)
        _, extra, _, _ = SPEC[name]
        fewer = dict(extra, altitudes=ALTS[:3])
        if 'frac_ice' in fewer:
            fewer['frac_ice'] = FRAC_ICE[:3]
        args = _call_args(name, forcing, 30, 60)
        got = _error(model.simulate, *args, **fewer, initial_state=state)
        want = _error(jax_model.simulate, *args, **fewer,
                      initial_state=_to_jax(state))
        assert got == want and "elevation layer" in got[1]
        got = _error(model.fit, np.ones(30), *args, **fewer,
                     initial_state=state)
        want = _error(jax_model.fit, np.ones(30), *args, **fewer,
                      initial_state=_to_jax(state))
        assert got == want


@pytest.mark.parametrize("engine", ['scan', 'fused'])
def test_short_history_raises_the_actionable_message(forcing, engine):
    model = _model('GR4J', params={'x1': 320., 'x2': 1.1, 'x3': 90.,
                                   'x4': 2.3})
    short = states.GR4JState(np.zeros(1), np.zeros(1), np.zeros((1, 5)))
    got = _error(model.simulate, forcing['prec'], forcing['etp'],
                 initial_state=short, engine=engine)
    want = _error(jax_models.GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90.,
                                          'x4': 2.3}).simulate,
                  forcing['prec'], forcing['etp'],
                  initial_state=_to_jax(short))
    assert got == want and "history taps" in got[1]
    # the fused fit runs (3, 7) registers: 5 taps are one short of its 6
    got = _error(model.fit, forcing['prec'], forcing['prec'],
                 forcing['etp'], initial_state=short, engine=engine)
    assert got[0] is ValueError
    assert ("history taps" if engine == 'fused' else
            "routing inputs") in got[1]


def test_x4_beyond_the_state_depth_message_matches_jax(forcing):
    model, jax_model = _model('GR4J'), jax_models.GR4J()
    p = {'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3}
    _, state = model.simulate(forcing['prec'], forcing['etp'], params=p,
                              return_final_state=True)
    wide = dict(p, x4=12.0)
    got = _error(model.simulate, forcing['prec'], forcing['etp'],
                 params=wide, initial_state=state)
    want = _error(jax_model.simulate, forcing['prec'], forcing['etp'],
                  params=wide, initial_state=_to_jax(state))
    assert got == want and "x4=12" in got[1]


def test_engine_guards(forcing):
    """ABC and the snow-only Cemaneige carry state on 'scan' only; the
    fused forecast path is discharge-only."""
    abc = _model('ABCModel')
    _, st = abc.simulate(forcing['prec'], return_final_state=True,
                         engine='fused')         # cold: the last storage
    assert isinstance(st, states.ABCState)
    with pytest.raises(ValueError, match="engine='scan' only"):
        abc.simulate(forcing['prec'], initial_state=st, engine='fused')
    snow = _model('Cemaneige')
    with pytest.raises(ValueError, match="engine='scan' only"):
        _sim(snow, 'Cemaneige', forcing, 0, 30, engine='fused',
             return_final_state=True)
    for name in ('GR4J', 'HBVEdu', 'CemaneigeGR4JIce'):
        with pytest.raises(ValueError, match="discharge only"):
            _sim(_model(name), name, forcing, 0, 30, engine='fused',
                 return_storage=True, return_final_state=True)
        with pytest.raises(ValueError, match="engine must be"):
            _sim(_model(name), name, forcing, 0, 30, engine='pallas',
                 return_final_state=True)


def test_unphysical_state_is_repaired_at_entry(forcing):
    """A negative routing store would turn ``x2 * (r / x3)**3.5`` NaN; the
    entry clips it, on both engines, as the reference does."""
    model = _model('GR4J')
    bad = states.GR4JState(s=np.array([50.0]), r=np.array([-3.0]),
                           pr_history=np.zeros((1, 20)))
    good = bad._replace(r=np.array([0.0]))
    for engine in ('scan', 'fused'):
        q = model.simulate(forcing['prec'], forcing['etp'],
                           initial_state=bad, engine=engine)
        assert bool(torch.isfinite(q).all())
        assert torch.equal(q, model.simulate(
            forcing['prec'], forcing['etp'], initial_state=good,
            engine=engine))


# ---------------------------------------------------------------------------
# Split invariance against the authors' series
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ['scan', 'fused'])
@pytest.mark.parametrize("split", [3, 400])
def test_gr4j_excel_series_survives_a_split(engine, split):
    params = {'x1': np.exp(5.76865628090826),
              'x2': np.sinh(1.61742503661094),
              'x3': np.exp(4.24316129943456),
              'x4': np.exp(-0.117506799276908) + 0.5}
    d = pd.read_csv(os.path.join(DATA_DIR, 'gr4j_example_data.csv'))
    prec, etp = np.asarray(d.prec), np.asarray(d.etp)
    model = _model('GR4J', params=params)
    q_a, st = model.simulate(prec[:split], etp[:split], s_init=0.6,
                             r_init=0.7, return_final_state=True,
                             engine=engine)
    q_b = model.simulate(prec[split:], etp[split:], initial_state=st,
                         engine=engine)
    assert np.allclose(torch.cat([q_a, q_b]).numpy().ravel(), d.qsim_excel)


@pytest.mark.parametrize("engine", ['scan', 'fused'])
def test_hbv_matlab_series_survives_a_split(engine):
    read = lambda name, **kw: pd.read_csv(os.path.join(DATA_DIR, name), **kw)
    daily = read('hbv_daily_inputs.txt', sep='\t',
                 names=['date', 'month', 'temp', 'prec'])
    monthly = read('hbv_monthly_inputs.txt', sep=' ',
                   names=['temp', 'not_needed', 'evap'])
    qsim_matlab = read('hbv_qsim.csv', header=None, names=['qsim'])
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    model = _model('HBVEdu', params=params)
    split = 1500
    cut = lambda lo, hi: (np.asarray(daily.temp)[lo:hi],
                          np.asarray(daily.prec)[lo:hi],
                          np.asarray(daily.month)[lo:hi], monthly.evap,
                          monthly.temp)
    q_a, st = model.simulate(*cut(0, split), snow_init=0, soil_init=100,
                             s1_init=3, s2_init=10, engine=engine,
                             return_final_state=True)
    q_b = model.simulate(*cut(split, None), initial_state=st, engine=engine)
    qsim = torch.cat([q_a, q_b]).numpy().ravel() * 410 * 1000 / 86400
    assert np.allclose(qsim, qsim_matlab.qsim)
