"""PyTorch port, ensemble data assimilation against JAX (CPU, float64).

``rrmpg_tpu_torch.tools.assimilation`` takes ``rrmpg_tpu.tools.
assimilation``'s names and parameters; its random numbers come from a
``torch.Generator``.  So the cores are held to JAX's with JAX's own
variates fed in (the EnKF analysis, the importance weights, systematic
resampling with JAX's uniform, the lognormal perturbation) at
``rtol=1e-10``, the flattening of every state bundle to JAX's column for
column, each class's window step (``_warm_cycle_pieces``) on one window
from one numpy-made state to JAX's at ``rtol=1e-10`` on both engines, and
whole cycles that draw nothing (the EnKF with ``obs_std=0``, the particle
filter with ``ess_threshold=0``) to JAX's at ``rtol=1e-9`` on both
backends.  With noise the port's host and scan backends consume one stream
alike and agree bit for bit; the statistical checks are JAX's.

JAX's HBV-Edu scan pieces index the monthly climatologies with the
1-based months (a month late, December clamped); the port makes them
0-based as ``simulate`` does, so JAX's scan backend is given 0-based months
here.  With ``obs_std=0`` every member is pulled onto the observation, so
an ensemble that estimates its parameters collapses after a few cycles and
the comparison there is kept to two.
"""

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu import models as jax_models
from rrmpg_tpu.models import states as jax_states
from rrmpg_tpu.ops.gr4j import GR4JState as JaxGR4JState
from rrmpg_tpu.tools import assimilation as ja
from rrmpg_tpu_torch import models as pt_models
from rrmpg_tpu_torch.interop import state_from_numpy
from rrmpg_tpu_torch.tools import (assimilation_cycle, enkf_update,
                                   particle_filter_update, perturb_state)
from rrmpg_tpu_torch.tools import assimilation as pa

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
RTOL_CORE = 1e-10
RTOL_CYCLE = 1e-9


class ToyState(typing.NamedTuple):
    a: torch.Tensor         # (N,)
    b: torch.Tensor         # (N, 2)
    g_thresh: torch.Tensor  # (N,) series constant: frozen by default


class JaxToyState(typing.NamedTuple):
    a: jnp.ndarray
    b: jnp.ndarray
    g_thresh: jnp.ndarray


def toy(a, b, g, kind=ToyState):
    conv = torch.tensor if kind is ToyState else jnp.asarray
    return kind(conv(np.asarray(a, np.float64)),
                conv(np.asarray(b, np.float64)),
                conv(np.asarray(g, np.float64)))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# State bundles in both packages, from one set of numpy leaves
# ---------------------------------------------------------------------------

def jax_bundle(name, leaves):
    if name == "SnowGR4JState":
        (snow_name, snow_leaves), gr4j_leaves = leaves
        return jax_states.SnowGR4JState(
            snow=jax_bundle(snow_name, snow_leaves),
            gr4j=jax_bundle("GR4JState", gr4j_leaves))
    cls = (JaxGR4JState if name == "GR4JState"
           else getattr(jax_states, name))
    return cls(*(jnp.asarray(x) for x in leaves))


def port_bundle(name, leaves):
    return state_from_numpy(name, leaves, **CPU)


def port_leaves(state):
    return [np.asarray(leaf) for _, leaf in pa._named_leaves(state)]


def jax_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def gr4j_leaves(rng, n, x1, x3, h=20):
    return (rng.uniform(0.2, 0.8, n) * x1, rng.uniform(0.2, 0.8, n) * x3,
            rng.uniform(0.0, 3.0, (n, h)))


def snow_leaves(rng, n, num_layers, hyst):
    shape = (n, num_layers)
    g = rng.uniform(0.0, 60.0, shape)
    etg = rng.uniform(-4.0, 0.0, shape)
    if hyst:
        return ("CemaneigeHystState",
                (g, etg, rng.uniform(0.0, 1.0, shape),
                 g + rng.uniform(0.0, 30.0, shape),
                 rng.uniform(100.0, 500.0, shape)))
    return "CemaneigeState", (g, etg, rng.uniform(50.0, 300.0, shape))


ALTITUDES = [550, 620, 700, 785, 920]
SNOW_KW = dict(met_station_height=495, altitudes=ALTITUDES)
FRAC_ICE = [0.1, 0.2, 0.3, 0.4, 0.5]
SNOW_CLASSES = {  # name: (hyst, ice)
    "CemaneigeGR4J": (False, False), "CemaneigeHystGR4J": (True, False),
    "CemaneigeGR4JIce": (False, True), "CemaneigeHystGR4JIce": (True, True)}
HBV_NEAR_GOLDEN = {'T_t': 0.0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35,
                   'C': 0.02, 'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03,
                   'K_2': 0.02, 'K_p': 0.05, 'L': 4.87}


class Setup(typing.NamedTuple):
    name: str
    jax_model: object
    port_model: object
    forcings: dict
    sim_kwargs: dict
    params: np.ndarray        # structured, the class's dtype
    state: tuple              # (bundle name, numpy leaves)
    obs: np.ndarray
    window: int

    def jax_scan_forcings(self):
        """JAX's HBV-Edu scan pieces take the months 0-based."""
        if self.name == "HBVEdu":
            return dict(self.forcings, month=self.forcings['month'] - 1)
        return self.forcings


@functools.lru_cache(maxsize=None)
def make_setup(name, n=32, cycles=6, window=10, seed=0):
    rng = np.random.default_rng(seed)
    T = window * cycles
    jm = getattr(jax_models, name)()
    pm = getattr(pt_models, name)(**CPU)
    np.random.seed(seed)
    params = jm.get_random_params(n)
    if name == "GR4J":
        forcings = {'prec': rng.gamma(0.8, 6.0, T),
                    'etp': rng.uniform(1.0, 4.0, T)}
        sim_kwargs = {}
        state = ("GR4JState", gr4j_leaves(rng, n, params['x1'],
                                          params['x3']))
    elif name == "ABCModel":
        forcings = {'prec': rng.gamma(0.8, 6.0, T)}
        sim_kwargs = {}
        state = ("ABCState", (rng.uniform(1.0, 20.0, n),))
    elif name == "HBVEdu":
        for k, v in HBV_NEAR_GOLDEN.items():
            lo, hi = pm._default_bounds[k]
            params[k] = np.clip(v * rng.uniform(0.9, 1.1, n)
                                + rng.uniform(-0.05, 0.05, n), lo, hi)
        forcings = {'temp': rng.uniform(-5.0, 15.0, T),
                    'prec': rng.gamma(0.8, 6.0, T),
                    'month': (np.arange(T) // 8) % 12 + 1}
        sim_kwargs = {'PE_m': rng.uniform(0.5, 4.0, 12),
                      'T_m': rng.uniform(-2.0, 15.0, 12)}
        state = ("HBVEduState", (rng.uniform(0, 20, n),
                                 rng.uniform(50, 150, n),
                                 rng.uniform(0, 10, n),
                                 rng.uniform(0, 20, n)))
    else:
        hyst, ice = SNOW_CLASSES[name]
        mt = rng.uniform(-10.0, 15.0, T)
        forcings = {'prec': rng.uniform(0.0, 15.0, T), 'mean_temp': mt,
                    'min_temp': mt - 2.0, 'max_temp': mt + 2.0,
                    'etp': rng.uniform(0.0, 4.0, T)}
        sim_kwargs = dict(SNOW_KW, **({'frac_ice': FRAC_ICE} if ice else {}))
        state = ("SnowGR4JState",
                 (snow_leaves(rng, n, len(ALTITUDES), hyst),
                  gr4j_leaves(rng, n, params['x1'], params['x3'])))
    # A reachable observation: member 0's free run, 20 % wetter.
    q_free = np.asarray(jm.simulate(
        **forcings, **sim_kwargs, params=params,
        initial_state=jax_bundle(*state)))
    obs = 1.2 * q_free[:, 0]
    return Setup(name, jm, pm, forcings, sim_kwargs, params, state, obs,
                 window)


# ---------------------------------------------------------------------------
# The cores with JAX's variates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,inflation", [(1, 1.0), (2, 1.0), (2, 1.3)])
def test_analysis_matches_jax(d, inflation):
    rng = np.random.default_rng(d)
    n, s = 64, 5
    X = rng.normal(size=(n, s))
    Y = X[:, :d] @ rng.normal(size=(d, d)) + rng.normal(0, 0.1, (n, d))
    obs = rng.normal(size=d)
    std = rng.uniform(0.2, 0.5, d)
    key = jax.random.PRNGKey(d)
    want = ja._analysis(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(obs),
                        jnp.asarray(std), key, jnp.asarray(inflation))
    eps = std * np.asarray(jax.random.normal(key, Y.shape,
                                             dtype=jnp.float64))
    got = pa._analysis(*(torch.tensor(a) for a in (X, Y, obs, std, eps)),
                       inflation)
    close(got, want, RTOL_CORE, 1e-13)


@pytest.mark.parametrize("d", [1, 3])
def test_pf_weights_match_jax(d):
    rng = np.random.default_rng(10 + d)
    n = 200
    Y = rng.normal(size=(n, d))
    obs, std = rng.normal(size=d), rng.uniform(0.3, 1.0, d)
    w_prior = rng.uniform(0.1, 1.0, n)
    w_prior /= w_prior.sum()
    want = ja._pf_weights(*(jnp.asarray(a) for a in (Y, obs, std, w_prior)))
    got = pa._pf_weights(*(torch.tensor(a) for a in (Y, obs, std, w_prior)))
    close(got, want, RTOL_CORE, 1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, 300) ** 4
    w /= w.sum()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ja._systematic_resample_indices(jnp.asarray(w), key))
    u = jax.random.uniform(key, (), dtype=jnp.float64)
    got = pa._systematic_resample_indices(torch.tensor(w),
                                          torch.tensor(float(u)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_resample_index_clamped_where_the_cumsum_ends_short():
    """A float32 cumulative sum that ends below the last position: JAX's
    searchsorted answers N, which its gather clamps to N - 1; the port
    clamps the index."""
    n = 1000
    # Normalized weights whose float32 sum rounds below 1, in any order of
    # summation.
    w = np.full(n, (1.0 - 2e-6) / n, np.float32)
    end = max(float(np.asarray(jnp.cumsum(jnp.asarray(w)))[-1]),
              float(torch.cumsum(torch.tensor(w), 0)[-1]))
    assert end < 1.0
    for i in range(10000):
        key = jax.random.PRNGKey(i)
        u = np.float32(jax.random.uniform(key, (), dtype=jnp.float32))
        if np.float32((np.float32(n - 1) + u) / np.float32(n)) > end:
            break
    else:
        pytest.fail("no key gives a last position past the sum")
    want = np.asarray(ja._systematic_resample_indices(jnp.asarray(w), key))
    assert want.max() == n
    got = pa._systematic_resample_indices(torch.tensor(w),
                                          torch.tensor(u)).numpy()
    assert got.max() == n - 1
    # The two cumulative sums round differently in float32, so the indices
    # are held to numpy's search of the port's own sum.
    positions = (np.arange(n, dtype=np.float32) + u) / np.float32(n)
    cumsum = torch.cumsum(torch.tensor(w), 0).numpy()
    np.testing.assert_array_equal(
        got, np.minimum(np.searchsorted(cumsum, positions), n - 1))


@pytest.mark.parametrize("rel_std,abs_std", [(0.3, 0.0), (0.2, 0.5)])
def test_perturbation_matches_jax(rel_std, abs_std):
    rng = np.random.default_rng(3)
    n = 50
    leaves = (rng.uniform(1, 5, n), rng.uniform(1, 5, (n, 2)),
              rng.uniform(1, 5, n))
    key = jax.random.PRNGKey(7)
    want = ja.perturb_state(toy(*leaves, kind=JaxToyState), key,
                            rel_std=rel_std, abs_std=abs_std)
    k_mul, k_add = jax.random.split(key)
    state = toy(*leaves)
    X, rebuild = pa._flatten_state(state, pa.CONSTANT_FIELDS)
    z_mul = torch.tensor(np.asarray(jax.random.normal(k_mul, X.shape)))
    z_add = torch.tensor(np.asarray(jax.random.normal(k_add, X.shape)))
    got = rebuild(pa._perturb(X, z_mul, z_add, rel_std, abs_std))
    for a, b in zip(port_leaves(got), jax_leaves(want)):
        close(a, b, RTOL_CORE)


# ---------------------------------------------------------------------------
# Flattening: JAX's column order, exact field-name freezing
# ---------------------------------------------------------------------------

def _bundles(rng, n=6):
    x1, x3 = rng.uniform(100, 1200, n), rng.uniform(20, 300, n)
    return {
        "GR4JState": ("GR4JState", gr4j_leaves(rng, n, x1, x3)),
        "ABCState": ("ABCState", (rng.uniform(0, 9, n),)),
        "HBVEduState": ("HBVEduState",
                        tuple(rng.uniform(0, 9, n) for _ in range(4))),
        "CemaneigeState": snow_leaves(rng, n, 3, False),
        "CemaneigeHystState": snow_leaves(rng, n, 3, True),
        "SnowGR4JState plain": ("SnowGR4JState", (
            snow_leaves(rng, n, 2, False), gr4j_leaves(rng, n, x1, x3))),
        "SnowGR4JState hyst": ("SnowGR4JState", (
            snow_leaves(rng, n, 5, True), gr4j_leaves(rng, n, x1, x3, 6))),
    }


@pytest.mark.parametrize("kind", list(_bundles(np.random.default_rng(0))))
@pytest.mark.parametrize("frozen", [pa.CONSTANT_FIELDS, frozenset({"s"}),
                                    frozenset({"g", "r"}), frozenset()])
def test_flatten_matches_jax(kind, frozen):
    name, leaves = _bundles(np.random.default_rng(0))[kind]
    jax_state, port_state = jax_bundle(name, leaves), port_bundle(name,
                                                                  leaves)
    X_jax, _ = ja._flatten_state(jax_state, frozen)
    X, rebuild = pa._flatten_state(port_state, frozen)
    np.testing.assert_array_equal(X.numpy(), np.asarray(X_jax))
    back = rebuild(X + 1.0)
    for (field, old), new in zip(pa._named_leaves(port_state),
                                 port_leaves(back)):
        shift = 0.0 if field in frozen else 1.0
        np.testing.assert_array_equal(new, old.numpy() + shift)
    assert type(back) is type(port_state)


def test_flatten_toy_state_and_frozen_s_keeps_pr_history():
    rng = np.random.default_rng(1)
    leaves = (rng.normal(size=8), rng.normal(size=(8, 2)), rng.normal(size=8))
    X_jax, _ = ja._flatten_state(toy(*leaves, kind=JaxToyState),
                                 ja.CONSTANT_FIELDS)
    X, _ = pa._flatten_state(toy(*leaves), pa.CONSTANT_FIELDS)
    np.testing.assert_array_equal(X.numpy(), np.asarray(X_jax))
    # frozen={'s'} freezes the store, never 'pr_history'.
    n = 32
    state = port_bundle("GR4JState", gr4j_leaves(rng, n, np.full(n, 300.0),
                                                 np.full(n, 90.0), 6))
    new = enkf_update(state, state.s, 150.0, 0.5, gen(1), frozen={'s'})
    np.testing.assert_array_equal(new.s.numpy(), state.s.numpy())
    assert not np.allclose(new.pr_history.numpy(),
                           state.pr_history.numpy())


# ---------------------------------------------------------------------------
# Each class's window step against JAX's
# ---------------------------------------------------------------------------

WARM_CLASSES = ["GR4J", "ABCModel", "HBVEdu", *SNOW_CLASSES]


@functools.lru_cache(maxsize=None)
def jax_warm_step(name):
    """JAX's window step of ``name`` on the warm-step setup (once for both
    of the port's engines)."""
    s = make_setup(name, n=24, cycles=1, window=40, seed=5)
    j_arrays, j_step = s.jax_model._warm_cycle_pieces(s.jax_scan_forcings(),
                                                      s.sim_kwargs)
    return j_step(j_arrays, jax_bundle(*s.state),
                  {k: jnp.asarray(s.params[k]) for k in s.params.dtype.names})


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("name", WARM_CLASSES)
def test_warm_step_matches_jax(name, engine):
    s = make_setup(name, n=24, cycles=1, window=40, seed=5)
    kw = dict(s.sim_kwargs, engine=engine)
    if name == "ABCModel" and engine == "fused":
        with pytest.raises(ValueError, match="engine='scan' only"):
            s.port_model._warm_cycle_pieces(s.forcings, kw)
        return
    arrays, step = s.port_model._warm_cycle_pieces(s.forcings, kw)
    params = {k: torch.tensor(s.params[k]) for k in s.params.dtype.names}
    q, final = step(arrays, port_bundle(*s.state), params)
    q_j, final_j = jax_warm_step(name)
    assert tuple(q.shape) == (24, 40)
    close(q, q_j, RTOL_CORE, 1e-12)
    for a, b in zip(port_leaves(final), jax_leaves(final_j)):
        close(a, b, RTOL_CORE, 1e-12)


def test_hbv_jax_scan_pieces_take_months_one_based():
    """The reference's fault the port does not keep: JAX's HBV-Edu pieces
    give the 1-based months to the 0-based climatology gather."""
    s = make_setup("HBVEdu", n=4, cycles=1, window=40, seed=5)
    j_arrays, j_step = s.jax_model._warm_cycle_pieces(s.forcings,
                                                      s.sim_kwargs)
    params = {k: jnp.asarray(s.params[k]) for k in s.params.dtype.names}
    q_raw, _ = j_step(j_arrays, jax_bundle(*s.state), params)
    q_sim = np.asarray(s.jax_model.simulate(
        **s.forcings, **s.sim_kwargs, params=s.params,
        initial_state=jax_bundle(*s.state)))
    assert not np.allclose(np.asarray(q_raw).T, q_sim, rtol=1e-6)
    arrays, step = s.port_model._warm_cycle_pieces(s.forcings, s.sim_kwargs)
    q, _ = step(arrays, port_bundle(*s.state),
                {k: torch.tensor(s.params[k]) for k in s.params.dtype.names})
    close(q.T, q_sim, RTOL_CORE, 1e-12)


# ---------------------------------------------------------------------------
# Whole cycles that draw nothing, against JAX on both backends
# ---------------------------------------------------------------------------

CYCLE_CONFIGS = {  # name: (assimilation_cycle kwargs, cycles)
    "enkf": (dict(obs_std=0.0), 5),
    "enkf_inflation": (dict(obs_std=0.0, inflation=1.1), 5),
    "enkf_params": (dict(obs_std=0.0, estimate_params=True,
                         inflation=1.05), 2),
    "pf": (dict(obs_std=0.3, method="pf", ess_threshold=0.0), 5),
}
CYCLE_MODELS = ["GR4J", "HBVEdu", "ABCModel", "CemaneigeHystGR4JIce"]


@pytest.fixture(scope="module")
def jax_cycles():
    cache = {}

    def get(name, config, backend):
        key = (name, config, backend)
        if key not in cache:
            kwargs, cycles = CYCLE_CONFIGS[config]
            s = make_setup(name, cycles=cycles)
            if kwargs.get("estimate_params"):
                kwargs = dict(kwargs, param_bounds=s.jax_model._default_bounds)
            forcings = s.jax_scan_forcings() if backend == "scan" else \
                s.forcings
            cache[key] = (s, ja.assimilation_cycle(
                s.jax_model, forcings, s.obs, s.window,
                params=s.params, initial_state=jax_bundle(*s.state),
                backend=backend, **kwargs, **s.sim_kwargs))
        return cache[key]

    return get


@pytest.mark.parametrize("backend", ["host", "scan"])
@pytest.mark.parametrize("config", list(CYCLE_CONFIGS))
@pytest.mark.parametrize("name", CYCLE_MODELS)
def test_deterministic_cycle_matches_jax(jax_cycles, name, config, backend):
    s, (j_state, j_params, j_q, j_d) = jax_cycles(name, config, backend)
    kwargs, _ = CYCLE_CONFIGS[config]
    if kwargs.get("estimate_params"):
        kwargs = dict(kwargs, param_bounds=s.port_model._default_bounds)
    # The fused engine's plain version on the scan backend, the sequential
    # ops on the host backend (ABC has only those).
    engine = "fused" if backend == "scan" and name != "ABCModel" else "scan"
    state, params, q, d = assimilation_cycle(
        s.port_model, s.forcings, s.obs, s.window, params=s.params,
        initial_state=port_bundle(*s.state), backend=backend, engine=engine,
        **kwargs, **s.sim_kwargs)
    assert np.isfinite(q).all()
    close(q, j_q, RTOL_CYCLE, 1e-11)
    for field in ("innovation", "prior_spread", "posterior_mean",
                  "param_mean", "ess"):
        got, want = getattr(d, field), getattr(j_d, field)
        assert (got is None) == (want is None), field
        if got is not None:
            assert got.shape == np.asarray(want).shape, field
            close(got, want, RTOL_CYCLE, 1e-11)
    for a, b in zip(port_leaves(state), jax_leaves(j_state)):
        close(a, b, RTOL_CYCLE, 1e-11)
    for k in s.params.dtype.names:
        close(params[k], j_params[k], RTOL_CYCLE, 1e-11)


# ---------------------------------------------------------------------------
# The port's two backends under one generator
# ---------------------------------------------------------------------------

NOISY = {
    "enkf": dict(obs_std=0.05),
    "enkf_params": dict(obs_std=0.05, estimate_params=True, inflation=1.02),
    "pf": dict(obs_std=0.1, method="pf", ess_threshold=0.7, jitter=0.1),
    "pf_params": dict(obs_std=0.1, method="pf", ess_threshold=1.0,
                      jitter=0.15, estimate_params=True),
}


@pytest.mark.parametrize("config", list(NOISY))
@pytest.mark.parametrize("name,engine", [("GR4J", "fused"), ("GR4J", "scan"),
                                         ("HBVEdu", "fused"),
                                         ("CemaneigeGR4J", "fused")])
def test_host_equals_scan_under_one_generator(name, engine, config):
    s = make_setup(name, n=48, cycles=6)
    kwargs = dict(NOISY[config])
    if kwargs.get("estimate_params"):
        kwargs["param_bounds"] = s.port_model._default_bounds
    runs = [assimilation_cycle(
        s.port_model, s.forcings, s.obs, s.window, params=s.params,
        initial_state=port_bundle(*s.state), key=gen(11), backend=backend,
        engine=engine, **kwargs, **s.sim_kwargs)
        for backend in ("host", "scan")]
    (sh, ph, qh, dh), (ss, ps, qs, ds) = runs
    np.testing.assert_array_equal(qs, qh)
    assert qh.flags['C_CONTIGUOUS'] and qs.flags['C_CONTIGUOUS']
    for field in dh._fields:
        a, b = getattr(dh, field), getattr(ds, field)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port_leaves(sh), port_leaves(ss)):
        np.testing.assert_array_equal(a, b)
    for k in s.params.dtype.names:
        np.testing.assert_array_equal(np.asarray(ph[k]), np.asarray(ps[k]))
    if config.startswith("pf"):
        assert (dh.ess < 0.7 * 48).any()     # it did resample
    first = s.params.dtype.names[0]
    assert (np.asarray(ph[first]) != s.params[first]).any() == (
        config != "enkf")


# ---------------------------------------------------------------------------
# The statistics of JAX's tests
# ---------------------------------------------------------------------------

def _gaussian(rng, n, mean, cov):
    return np.asarray(mean) + rng.normal(size=(n, len(mean))) @ \
        np.linalg.cholesky(cov).T


def test_enkf_matches_kalman_posterior():
    n = 40000
    mean0 = np.array([1.0, -2.0, 0.5])
    cov0 = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.4], [0.0, 0.4, 0.5]])
    H = np.array([[1.0, 0.0, 1.0]])
    obs, r = np.array([3.0]), 0.25
    X = _gaussian(np.random.default_rng(0), n, mean0, cov0)
    state = toy(X[:, 0], X[:, 1:3], np.full(n, 7.7))
    new = enkf_update(state, X @ H.T, obs, 0.5, gen(0))
    Xa = np.column_stack([new.a.numpy(), new.b.numpy()])
    S = H @ cov0 @ H.T + r
    K = cov0 @ H.T / S
    np.testing.assert_allclose(Xa.mean(axis=0),
                               mean0 + (K @ (obs - H @ mean0)).ravel(),
                               atol=0.02)
    np.testing.assert_allclose(np.cov(Xa.T), cov0 - K @ H @ cov0, atol=0.04)
    np.testing.assert_array_equal(new.g_thresh.numpy(), 7.7)


def test_inflation_consistent_with_kalman():
    n, infl = 200_000, 2.0
    x = 1.0 + np.random.default_rng(0).normal(size=n)
    state = toy(x, np.zeros((n, 2)), np.zeros(n))
    a = enkf_update(state, x, 3.0, 0.5, gen(0), inflation=infl).a.numpy()
    p = np.var(x) * infl ** 2
    gain = p / (p + 0.25)
    assert a.mean() == pytest.approx(np.mean(x) + gain * (3.0 - np.mean(x)),
                                     abs=0.02)
    assert a.var() == pytest.approx((1 - gain) * p, abs=0.02)
    assert a.mean() < 3.0


def test_inflation_widens_prior_and_frozen_and_postprocess():
    n = 4096
    rng = np.random.default_rng(0)
    state = toy(rng.normal(size=n), np.zeros((n, 2)), np.zeros(n))
    pred = 1000.0 + np.random.default_rng(1).normal(0, 1e-6, n)
    new = enkf_update(state, pred, 1000.0, 1e6, gen(3), inflation=1.5)
    assert float(new.a.std() / state.a.std()) == pytest.approx(1.5, rel=1e-3)
    new = enkf_update(state, np.ones(n) * 2, 1.0, 1.0, gen(2),
                      frozen=pa.CONSTANT_FIELDS | {"b"})
    np.testing.assert_array_equal(new.b.numpy(), state.b.numpy())
    lin = toy(np.linspace(-1, 1, 64), np.ones((64, 2)), np.ones(64))
    clipped = enkf_update(lin, lin.a, 0.0, 10.0, gen(4),
                          postprocess=lambda s: s._replace(
                              a=torch.clamp(s.a, min=0.0)))
    assert float(clipped.a.min()) >= 0.0


def test_enkf_params_structured_roundtrip():
    n = 64
    state = toy(np.random.default_rng(0).normal(0, 1, n), np.ones((n, 2)),
                np.ones(n))
    params = np.zeros(n, dtype=[('k1', np.float64), ('k2', np.float64)])
    params['k1'] = np.random.default_rng(1).normal(2.0, 0.5, n)
    params['k2'] = 5.0
    new_state, new_params = enkf_update(
        state, state.a.numpy() + params['k1'], 2.0, 0.1, gen(0),
        params=params, param_bounds={'k1': (0.0, 4.0)})
    assert isinstance(new_params, np.ndarray)
    assert new_params.dtype.names == ('k1', 'k2')
    assert not np.allclose(new_params['k1'], params['k1'])
    np.testing.assert_allclose(new_params['k2'], 5.0)
    assert (new_params['k1'] >= 0.0).all() and (new_params['k1'] <= 4.0).all()
    _, as_dict = enkf_update(state, state.a, 2.0, 0.1, gen(0),
                             params={'k1': torch.tensor(params['k1'])})
    assert isinstance(as_dict['k1'], torch.Tensor)


def test_perturb_state_statistics():
    n = 8192
    state = toy(np.full(n, 10.0), np.full((n, 2), 4.0), np.full(n, 2.0))
    new = perturb_state(state, gen(0), rel_std=0.3)
    np.testing.assert_array_equal(new.g_thresh.numpy(), 2.0)
    assert float(new.a.mean()) == pytest.approx(10.0, rel=0.02)
    assert float(new.a.std()) > 1.0 and float(new.a.min()) > 0.0
    zeros = toy(np.zeros(1024), np.zeros((1024, 2)), np.zeros(1024))
    np.testing.assert_array_equal(
        perturb_state(zeros, gen(0), rel_std=0.5).a.numpy(), 0.0)
    floored = perturb_state(zeros, gen(0), rel_std=0.5, abs_std=0.1)
    assert float(floored.a.std()) == pytest.approx(0.1, rel=0.1)
    # One generator, one stream: the same seed gives the same draw.
    again = perturb_state(state, None, rel_std=0.3)
    np.testing.assert_array_equal(again.a.numpy(), new.a.numpy())


def test_pf_matches_bayes_posterior():
    n = 200_000
    x = 1.0 + np.random.default_rng(0).normal(size=n)
    state = toy(x, np.zeros((n, 2)), np.zeros(n))
    new, info = particle_filter_update(state, x, 2.0, 0.5, gen(0),
                                       ess_threshold=1.0)
    assert info.resampled
    var_post = 1.0 / (1.0 + 4.0)
    a = new.a.numpy()
    assert a.mean() == pytest.approx(var_post * (1.0 + 8.0), abs=0.02)
    assert a.var() == pytest.approx(var_post, abs=0.02)


def test_pf_weights_ess_and_accumulation():
    n = 256
    x = np.random.default_rng(0).normal(0, 1, n)
    state = toy(x, np.zeros((n, 2)), np.zeros(n))
    new, info1 = particle_filter_update(state, x, 1.0, 10.0, gen(1),
                                        ess_threshold=0.0)
    assert not info1.resampled
    np.testing.assert_array_equal(new.a.numpy(), x)
    _, info2 = particle_filter_update(state, x, 2.0, 10.0, gen(2),
                                      weights=info1.next_weights,
                                      ess_threshold=0.0)
    w = np.exp(-0.5 * ((1.0 - x) / 10.0) ** 2 - 0.5 * ((2.0 - x) / 10.0) ** 2)
    w /= w.sum()
    np.testing.assert_allclose(info2.weights, w, atol=1e-12)
    assert info2.ess == pytest.approx(1.0 / np.sum(w ** 2), rel=1e-6)


def test_pf_resampling_permutes_params_constants_and_jitters():
    n = 256
    x = np.random.default_rng(1).normal(0, 1, n)
    tag = np.arange(n, dtype=float)
    state = toy(x, np.zeros((n, 2)), tag)
    params = np.zeros(n, dtype=[('k', np.float64)])
    params['k'] = tag
    new, new_params, info = particle_filter_update(
        state, x, 3.0, 0.1, gen(2), params=params, ess_threshold=1.0)
    assert info.resampled
    np.testing.assert_array_equal(new.g_thresh.numpy(), new_params['k'])
    assert len(np.unique(new_params['k'])) < n
    assert new.a.numpy().mean() > x.mean()
    lin = np.linspace(-3, 3, 4096)
    new, info = particle_filter_update(
        toy(lin, np.ones((4096, 2)), np.full(4096, 9.0)), lin, 3.0, 0.05,
        gen(3), ess_threshold=1.0, jitter=0.1)
    assert len(np.unique(new.a.numpy())) > 2048
    np.testing.assert_array_equal(new.g_thresh.numpy(), 9.0)
    _, kp, _ = particle_filter_update(
        toy(x[:128], np.zeros((128, 2)), np.zeros(128)), x[:128], 0.0, 0.05,
        gen(4), params={'k': np.full(128, 3.9)}, ess_threshold=1.0,
        param_jitter=0.5, param_bounds={'k': (0.0, 4.0)})
    k = kp['k'].numpy()
    assert (k <= 4.0).all() and (k >= 0.0).all() and len(np.unique(k)) > 1


def _twin(n, method_kw, backend, seed_state=7):
    rng = np.random.default_rng(42)
    T, window = 240, 12
    prec, etp = rng.gamma(0.8, 6.0, T), rng.uniform(1, 4, T)
    truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
    model = pt_models.GR4J(params=truth, **CPU)
    q_true = model.simulate(prec, etp, s_init=0.9, r_init=0.7)[:, 0].numpy()
    obs = q_true + rng.normal(0, 0.02, T)
    params = {k: np.full(n, v) for k, v in truth.items()}
    _, st0 = model.simulate(prec[:window], etp[:window], s_init=0.15,
                            r_init=0.15, params=params,
                            return_final_state=True)
    st0 = perturb_state(st0, gen(seed_state), rel_std=0.4)
    q_free = model.simulate(prec[window:], etp[window:], params=params,
                            initial_state=st0).numpy()
    _, _, q_da, diags = assimilation_cycle(
        model, {'prec': prec[window:], 'etp': etp[window:]}, obs[window:],
        window, params=params, seed=0, initial_state=st0, backend=backend,
        **method_kw)
    skip = 5 * window
    err = [np.sqrt(np.mean((q[skip:].mean(axis=1) - q_true[window + skip:])
                           ** 2)) for q in (q_da, q_free)]
    return err, diags


@pytest.mark.parametrize("backend", ["host", "scan"])
def test_enkf_twin_experiment_beats_free_run(backend):
    (rmse_da, rmse_free), diags = _twin(64, dict(obs_std=0.05), backend)
    assert rmse_da < 0.5 * rmse_free
    assert (np.abs(diags.innovation[-5:]).mean()
            < np.abs(diags.innovation[:3]).mean())


def test_pf_twin_experiment_beats_free_run():
    (rmse_pf, rmse_free), diags = _twin(512, dict(obs_std=0.1, method='pf',
                                                  jitter=0.15), "scan")
    assert rmse_pf < 0.5 * rmse_free
    assert diags.ess is not None and len(diags.ess) == 19


def test_pf_cycle_permutes_heterogeneous_params():
    rng = np.random.default_rng(5)
    T, window, n = 48, 12, 32
    prec, etp = rng.gamma(0.8, 6.0, T), rng.uniform(1, 4, T)
    base = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
    model = pt_models.GR4J(params=base, **CPU)
    obs = model.simulate(prec, etp, s_init=0.8, r_init=0.6)[:, 0].numpy()
    params = {k: np.full(n, v) for k, v in base.items()}
    params['x2'] = rng.uniform(-2, 2, n)
    _, out, _, _ = assimilation_cycle(
        model, {'prec': prec, 'etp': etp}, obs, window, obs_std=0.02,
        params=params, seed=0, cold_start_kwargs={'s_init': 0.3,
                                                  'r_init': 0.3},
        method='pf', ess_threshold=1.0)
    x2 = out['x2'].numpy()
    assert np.isin(x2, params['x2']).all() and len(np.unique(x2)) < n


# ---------------------------------------------------------------------------
# JAX's guards, with JAX's messages
# ---------------------------------------------------------------------------

def test_update_guards():
    one = toy(np.ones(1), np.ones((1, 2)), np.ones(1))
    with pytest.raises(ValueError, match="N >= 2"):
        enkf_update(one, np.ones(1), 1.0, 1.0, gen())
    with pytest.raises(ValueError, match="N >= 2"):
        particle_filter_update(one, np.ones(1), 1.0, 1.0, gen())
    eight = toy(np.ones(8), np.ones((8, 2)), np.ones(8))
    with pytest.raises(ValueError, match="predicted"):
        enkf_update(eight, np.ones((8, 3)), np.array([1.0, 2.0]), 1.0, gen())
    with pytest.raises(ValueError, match="predicted"):
        particle_filter_update(eight, np.ones((8, 3)), np.array([1.0, 2.0]),
                               1.0, gen())
    with pytest.raises(ValueError, match="frozen"):
        enkf_update(eight, np.ones(8), 1.0, 1.0, gen(),
                    frozen={"a", "b", "g_thresh"})
    with pytest.raises(ValueError, match="expected \\(8,\\)"):
        enkf_update(eight, np.ones(8), 1.0, 1.0, gen(),
                    params={'k': np.ones(5)})
    with pytest.raises(TypeError, match="JAX PRNG key"):
        enkf_update(eight, np.arange(8.0), 1.0, 1.0, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="JAX PRNG key"):
        perturb_state(eight, jax.random.PRNGKey(0))


def test_cycle_guards():
    s = make_setup("GR4J", n=4, cycles=3)
    m, f, obs = s.port_model, s.forcings, s.obs
    pe = {k: s.params[k] for k in s.params.dtype.names}
    st = port_bundle(*s.state)
    with pytest.raises(ValueError, match="method"):
        assimilation_cycle(m, f, obs, 10, 0.1, params=pe, method='4dvar')
    with pytest.raises(ValueError, match="backend"):
        assimilation_cycle(m, f, obs, 10, 0.1, params=pe, backend='device',
                           initial_state=st)
    with pytest.raises(ValueError, match="initial_state"):
        assimilation_cycle(m, f, obs, 10, 0.1, params=pe, backend='scan',
                           cold_start_kwargs={'s_init': 0.3})
    with pytest.raises(ValueError, match="params"):
        assimilation_cycle(m, f, obs, 10, 0.1, estimate_params=True)
    with pytest.raises(ValueError, match="window"):
        assimilation_cycle(m, f, obs, 50, 0.1, params=pe)
    with pytest.raises(ValueError, match="length"):
        assimilation_cycle(m, {'prec': f['prec'], 'etp': f['etp'][:20]},
                           obs, 10, 0.1, params=pe)
    with pytest.raises(ValueError, match="obs"):
        assimilation_cycle(m, f, obs[:25], 10, 0.1, params=pe)
    with pytest.raises(TypeError, match="JAX PRNG key"):
        assimilation_cycle(m, f, obs, 10, 0.1, params=pe,
                           key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="no extra forcing kwargs"):
        assimilation_cycle(m, f, obs, 10, 0.1, params=pe, backend='scan',
                           initial_state=st, interpret=True)


def test_scan_backend_guards_of_abc_and_cemaneige():
    s = make_setup("ABCModel", n=4, cycles=2)
    with pytest.raises(ValueError, match="engine='scan' only"):
        assimilation_cycle(s.port_model, s.forcings, s.obs, 10, 0.1,
                           params=s.params, backend='scan', engine='fused',
                           initial_state=port_bundle(*s.state))
    model = pt_models.Cemaneige(**CPU)
    rng = np.random.default_rng(0)
    mt = rng.uniform(-5, 5, 30)
    forcings = {'prec': rng.uniform(0, 5, 30), 'mean_temp': mt,
                'min_temp': mt - 1, 'max_temp': mt + 1}
    state = port_bundle(*snow_leaves(rng, 4, 1, False))
    with pytest.raises(ValueError, match="does not support backend='scan'"):
        assimilation_cycle(model, forcings, np.ones(30), 10, 0.1,
                           params=model.get_random_params(4),
                           backend='scan', initial_state=state,
                           met_station_height=500)
