"""PyTorch port, the snow ops against the JAX package (CPU, float64).

The same numpy inputs go through ``rrmpg_tpu.ops`` and
``rrmpg_tpu_torch.ops``: the met preprocessing (``ops/met.py``), the snow
routines (``ops/cemaneige.py``: plain, hysteresis, ice melt, cold and warm)
and the four GR4J compositions (``ops/compositions.py``), with 1 and 5
elevation layers.  The JAX functions take one parameter set and are mapped
over members with ``vmap``; the port's take the member axis themselves.

Tolerance ``rtol=1e-10, atol=1e-12``: the same float64 operations, with
sums over time (the series constants) and over layers taken in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import cemaneige as jax_cema
from rrmpg_tpu.ops import compositions as jax_comp
from rrmpg_tpu.ops import met as jax_met
from rrmpg_tpu_torch.interop import layer_forcing_from_numpy, params_from_numpy
from rrmpg_tpu_torch.ops import cemaneige, compositions, met

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-12)
SNOW_INITS = (2.0, -1.0)
BOUNDS = {'CTG': (0, 1), 'Kf': (0, 10), 'Thacc': (1, 100), 'Rsp': (0, 1),
          'x1': (10, 1200), 'x2': (-5, 3), 'x3': (20, 5000),
          'x4': (1.1, 9.9), 'DDF': (0, 30)}


def _inputs(T, L, N, seed):
    """Layer forcing (prec, temp, frac: (T, L)), etp (T,), frac_ice (L,)
    and (N,) parameter arrays."""
    rng = np.random.default_rng(seed)
    forcing = (rng.uniform(0, 15, (T, L)), rng.uniform(-12, 18, (T, L)),
               np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
    etp = rng.uniform(0, 4, T)
    frac_ice = rng.uniform(0, 0.7, L)
    params = {k: rng.uniform(lo, hi, N) for k, (lo, hi) in BOUNDS.items()}
    return forcing, etp, frac_ice, params


def _t(*arrays):
    out = tuple(torch.tensor(np.asarray(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def _p64(params):
    return params_from_numpy(params, device='cpu', dtype=F64)


def _vmap(fn, params):
    return jax.vmap(fn)({k: jnp.asarray(v) for k, v in params.items()})


def _assert_tree_close(got, want):
    """Nested tuples of tensors against nested tuples of JAX arrays; a JAX
    leaf without the member axis (a series constant, the rain series) is
    compared with the port's unbatched tensor."""
    if isinstance(got, torch.Tensor):
        want = np.asarray(want)
        if want.shape != tuple(got.shape):        # vmap replicated it
            np.testing.assert_allclose(want, np.broadcast_to(want[0],
                                                             want.shape))
            want = want[0]
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_tree_close(g, w)


# ---------------------------------------------------------------------------
# met
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("station", [495.0, 1700.0, 4200.0])
def test_met_extrapolation_matches_jax(station):
    rng = np.random.default_rng(0)
    T = 60
    altitudes = np.array([550.0, 1499.0, 1500.0, 2300.0, 4000.0, 4600.0])
    prec = rng.uniform(0, 20, T)
    mean_t = rng.uniform(-6, 6, T)
    min_t, max_t = mean_t - rng.uniform(0, 4, T), mean_t + rng.uniform(0, 4, T)
    got_prec = met.extrapolate_precipitation(_t(prec), altitudes, station)
    want_prec = jax_met.extrapolate_precipitation(prec, altitudes, station)
    assert got_prec.shape == (T, 6)
    np.testing.assert_allclose(got_prec.numpy(), np.asarray(want_prec), **TOL)
    got = met.extrapolate_temperature(*_t(min_t, mean_t, max_t), altitudes,
                                      station)
    want = jax_met.extrapolate_temperature(min_t, mean_t, max_t, altitudes,
                                           station)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_solid_fraction_matches_jax_in_both_regimes():
    rng = np.random.default_rng(1)
    T = 80
    altitudes = np.array([550.0, 1499.0, 1500.0, 2300.0])
    mean_t = rng.uniform(-6, 6, (T, 4))
    min_t, max_t = mean_t - rng.uniform(0, 4, (T, 4)), mean_t + rng.uniform(
        0, 4, (T, 4))
    max_t[3], min_t[3] = 0.0, -2.0          # max == 0: all solid
    min_t[5] = max_t[5] = 1.5               # zero spread above freezing
    mean_t[7], mean_t[9] = 3.0, 0.0         # the high-elevation brackets
    prec = rng.uniform(0, 10, (T, 4))
    got = met.calculate_solid_fraction(_t(prec), altitudes,
                                       *_t(mean_t, min_t, max_t))
    want = jax_met.calculate_solid_fraction(prec, altitudes, mean_t, min_t,
                                            max_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert {0.0, 1.0} <= set(np.unique(got.numpy()))


def test_layer_forcing_from_numpy_places_and_checks():
    forcing, _, frac_ice, _ = _inputs(20, 3, 2, seed=2)
    prec, temp, frac, fi = layer_forcing_from_numpy(
        *forcing, frac_ice=frac_ice, device='cpu', dtype=F64)
    assert prec.shape == temp.shape == frac.shape == (20, 3)
    assert fi.shape == (3,) and fi.dtype == F64
    np.testing.assert_array_equal(temp.numpy(), forcing[1])
    with pytest.raises(ValueError, match=r"\(T, L\)"):
        layer_forcing_from_numpy(forcing[0], forcing[1][:-1], forcing[2],
                                 device='cpu')
    with pytest.raises(ValueError, match="frac_ice"):
        layer_forcing_from_numpy(*forcing, frac_ice=frac_ice[:-1],
                                 device='cpu')


# ---------------------------------------------------------------------------
# snow routines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 5])
def test_cemaneige_matches_jax_with_final_state(L):
    forcing, _, _, params = _inputs(220, L, 6, seed=3)
    want = _vmap(lambda p: jax_cema.run_cemaneige(
        *forcing, *SNOW_INITS, p, return_final=True), params)
    got = cemaneige.run_cemaneige(*_t(*forcing), *SNOW_INITS, _p64(params),
                                  return_final=True)
    assert got[0].shape == (6, 220) and got[1].shape == (6, 220, L)
    assert got[3][2].shape == (L,)                 # g_thresh of the series
    _assert_tree_close(got, want)


@pytest.mark.parametrize("L", [1, 5])
def test_cemaneigehyst_matches_jax_with_final_state(L):
    forcing, _, _, params = _inputs(220, L, 6, seed=4)
    want = _vmap(lambda p: jax_cema.run_cemaneigehyst(
        *forcing, *SNOW_INITS, 0.3, p, return_final=True), params)
    got = cemaneige.run_cemaneigehyst(*_t(*forcing), *SNOW_INITS, 0.3,
                                      _p64(params), return_final=True)
    assert len(got) == 6 and got[3].shape == (6, 220, L)
    assert got[4].shape == (220, L)                # rain: no member axis
    sca = got[3].numpy()
    assert sca.min() >= 0.0 and sca.max() <= 1.0 and 0 < sca.mean() < 1
    _assert_tree_close(got, want)


@pytest.mark.parametrize("hyst", [False, True])
def test_warm_snow_matches_jax_and_chains(hyst):
    """The warm routines against JAX (every member continues its own carried
    state), and a warm run split anywhere and chained through the returned
    state is the unbroken run.  The series constant belongs to the original
    series and is handed to every segment."""
    T, L, N, cut = 200, 5, 4, 70
    forcing, _, _, params = _inputs(T, L, N, seed=5)
    rng = np.random.default_rng(5)
    const = rng.uniform(50, 400, L)
    state = (rng.uniform(0, 30, (N, L)), rng.uniform(-3, 0, (N, L)))
    if hyst:
        state += (rng.uniform(0, 1, (N, L)), rng.uniform(0, 60, (N, L)))
        warm, jax_warm = (cemaneige.run_cemaneigehyst_warm,
                          jax_cema.run_cemaneigehyst_warm)
    else:
        warm, jax_warm = (cemaneige.run_cemaneige_warm,
                          jax_cema.run_cemaneige_warm)
    want = jax.vmap(lambda st, p: jax_warm(*forcing, st, const, p))(
        tuple(jnp.asarray(s) for s in state),
        {k: jnp.asarray(v) for k, v in params.items()})
    p64, tf = _p64(params), _t(*forcing)
    whole = warm(*tf, _t(*state), _t(const), p64)
    _assert_tree_close(whole, want)

    first = warm(*(a[:cut] for a in tf), _t(*state), _t(const), p64)
    rest = warm(*(a[cut:] for a in tf), first[-1], _t(const), p64)
    for k in range(4 if hyst else 3):              # outflow, G, eTG(, sca)
        np.testing.assert_allclose(
            torch.cat([first[k], rest[k]], dim=1).numpy(), whole[k].numpy(),
            **TOL)
    for a, b in zip(rest[-1], whole[-1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_icemelt_matches_jax_and_shields_under_snow():
    rng = np.random.default_rng(6)
    temp = rng.uniform(-10, 15, (50, 3))
    snow = rng.uniform(0, 3, (4, 50, 3))
    ddf = rng.uniform(0, 30, 4)
    got = cemaneige.run_icemelt(_t(temp), _t(snow), {'DDF': _t(ddf)})
    want = jax.vmap(lambda s, d: jax_cema.run_icemelt(temp, s, {'DDF': d}))(
        jnp.asarray(snow), jnp.asarray(ddf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[snow > 1.0] == 0).all() and got.numpy().max() > 0


def test_hyst_sca_init_is_inert():
    forcing, _, _, params = _inputs(120, 3, 3, seed=7)
    a = cemaneige.run_cemaneigehyst(*_t(*forcing), 0.0, 0.0, 0.0,
                                    _p64(params))
    b = cemaneige.run_cemaneigehyst(*_t(*forcing), 0.0, 0.0, 0.9,
                                    _p64(params))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------

def _composition(name, forcing, etp, frac_ice, inits, params, package,
                 **kw):
    """One of the four compositions with the reference's argument order."""
    prec, temp, frac = forcing
    fn = getattr(package, f"run_{name}")
    snow_inits = (2.0, -1.0, 0.25) if 'hyst' in name else (2.0, -1.0)
    args = (prec, temp, etp) + ((frac_ice,) if name.endswith('ice') else ())
    return fn(*args, frac, *snow_inits, *inits, params, **kw)


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("name,n_out", [
    ("cemaneigegr4j", 5), ("cemaneigehystgr4j", 7),
    ("cemaneigegr4jice", 6), ("cemaneigehystgr4jice", 9)])
def test_compositions_match_jax_with_final_state(name, n_out, L):
    forcing, etp, frac_ice, params = _inputs(180, L, 5, seed=8)
    want = _vmap(lambda p: _composition(
        name, forcing, etp, frac_ice, (0.4, 0.3), p, jax_comp,
        return_final=True), params)
    got = _composition(name, _t(*forcing), _t(etp), _t(frac_ice), (0.4, 0.3),
                       _p64(params), compositions, return_final=True)
    assert len(got) == n_out + 1 and got[0].shape == (5, 180)
    snow_final, gr4j_final = got[-1]
    assert gr4j_final.pr_history.shape == (5, 20)
    assert len(snow_final) == (5 if 'hyst' in name else 3)
    _assert_tree_close(got[:n_out], want[:n_out])
    _assert_tree_close(snow_final, want[-1][0])
    _assert_tree_close(tuple(gr4j_final), tuple(want[-1][1]))


def test_composition_short_uh_registers_match_default():
    """x4 <= 2.9 fits the (3, 7) registers: the same discharge."""
    forcing, etp, frac_ice, params = _inputs(150, 5, 4, seed=9)
    params['x4'] = np.random.default_rng(9).uniform(1.1, 2.9, 4)
    args = (_t(*forcing), _t(etp), _t(frac_ice), (0.4, 0.3), _p64(params),
            compositions)
    wide = _composition("cemaneigehystgr4jice", *args)
    short = _composition("cemaneigehystgr4jice", *args, num_uh1=3, num_uh2=7)
    np.testing.assert_allclose(short[0].numpy(), wide[0].numpy(), **TOL)
