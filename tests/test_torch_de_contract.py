"""PyTorch port, DE's remaining JAX contract (CPU, float64).

``differential_evolution``, ``gradient_descent`` and ``random_search`` take
the JAX package's parameters in its order, then ``device`` and ``dtype``.
``key`` is a ``torch.Generator`` (JAX's is a PRNG key, which cannot seed
torch's stream: it raises).  Every class's ``fit`` forwards ``mesh``,
``polish``, ``polish_steps``, ``checkpoint_path``, ``checkpoint_every`` and
``resume_from`` to DE, and all of them work: a run on a mesh of CPU shards
equals the run without one (the population exactly; the energies at
``rtol=1e-12``: ATen's vectorized ``pow`` and its scalar tail round alike
only to an ulp, and a member's place in its shard decides which it takes),
and what is not a mesh raises ``TypeError``.

* A run checkpointed every few generations and resumed equals the unbroken
  run bit for bit: the checkpoint holds the generator's state.
* ``gradient_descent`` from the same start equals JAX's at ``rtol=1e-8``:
  both are Adam (betas (0.9, 0.999), eps 1e-8) on the same float64
  objective, whose arithmetic differs only in rounding order.
* The random streams differ, so ``random_search`` is held to the minimum
  JAX's reaches (``atol=0.05``), as DE is in
  ``tests/test_torch_calibration_contract.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.tools.calibration as jax_calibration
from rrmpg_tpu.ops import run_gr4j as jax_run_gr4j
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.ops import run_gr4j
from rrmpg_tpu_torch.parallel import default_mesh
from rrmpg_tpu_torch.tools import (differential_evolution, gradient_descent,
                                   random_search)

torch.set_num_threads(1)

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
TARGET = np.array([0.5, -2.0])
BOUNDS = [(-5.0, 5.0)] * 2
CLASSES = ('GR4J', 'HBVEdu', 'ABCModel', 'Cemaneige', 'CemaneigeGR4J',
           'CemaneigeGR4JIce', 'CemaneigeHystGR4J', 'CemaneigeHystGR4JIce')
GR4J_BOUNDS = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]


def _quadratic(x):
    return ((x - torch.as_tensor(TARGET, dtype=x.dtype)) ** 2).sum()


def _quadratic_batched(X):
    return ((X - torch.as_tensor(TARGET, dtype=X.dtype)) ** 2).sum(1)


def _jax_quadratic(x):
    return jnp.sum((x - jnp.asarray(TARGET)) ** 2)


def _assert_same_run(a, b):
    """Two OptimizeResults equal bit for bit."""
    assert a.nit == b.nit and a.nfev == b.nfev and a.fun == b.fun
    assert a.success == b.success and a.message == b.message
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.population, b.population)
    np.testing.assert_array_equal(a.population_energies,
                                  b.population_energies)


# ---------------------------------------------------------------------------
# signatures and arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["differential_evolution",
                                  "gradient_descent", "random_search"])
def test_signature_is_jax_then_device_dtype(name):
    from rrmpg_tpu_torch.tools import calibration

    want = list(inspect.signature(getattr(jax_calibration,
                                          name)).parameters)
    got = list(inspect.signature(getattr(calibration, name)).parameters)
    assert got == want + ['device', 'dtype']
    if name == "differential_evolution":
        assert got[2] == 'key'


@pytest.mark.parametrize("call", [
    lambda key: differential_evolution(_quadratic, BOUNDS, key, maxiter=2,
                                       **CPU),
    lambda key: gradient_descent(_quadratic, BOUNDS, key=key, steps=2,
                                 **CPU),
    lambda key: random_search(_quadratic, lambda g, n: torch.rand(
        (n, 2), generator=g, dtype=F64), 8, key=key, **CPU)],
    ids=["de", "gradient_descent", "random_search"])
@pytest.mark.parametrize("key", [jax.random.PRNGKey(0),
                                 np.array([0, 7], dtype=np.uint32), 7],
                         ids=["jax_key", "uint32_pair", "int"])
def test_key_that_is_not_a_generator_raises(call, key):
    with pytest.raises(TypeError, match="JAX PRNG key cannot seed"):
        call(key)


def test_generator_key_is_the_seeded_stream():
    """``key=`` draws from the caller's generator: a generator seeded with
    3 walks the population ``seed=3`` walks, and advances."""
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state().clone()
    a = differential_evolution(_quadratic, BOUNDS, gen, maxiter=10, **CPU)
    b = differential_evolution(_quadratic, BOUNDS, seed=3, maxiter=10, **CPU)
    _assert_same_run(a, b)
    assert not torch.equal(gen.get_state(), before)


@pytest.mark.parametrize("mesh_call", [
    lambda: differential_evolution(_quadratic, BOUNDS, mesh=object(),
                                   **CPU),
    lambda: random_search(_quadratic, lambda g, n: torch.zeros(n, 2), 4,
                          mesh=object(), **CPU)],
    ids=["de", "random_search"])
def test_mesh_raises_not_implemented(mesh_call):
    """Since the mesh is ported, what is not a mesh raises ``TypeError``.
    The name predates the port of the mesh and is kept."""
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        mesh_call()


# ---------------------------------------------------------------------------
# the model classes' fit
# ---------------------------------------------------------------------------

def _fit_inputs(name, T=30):
    """(model, obs, keyword forcing) of class ``name`` on the CPU."""
    rng = np.random.default_rng(5)
    obs = rng.uniform(0.5, 4, T)
    if name == 'GR4J':
        kw = dict(prec=rng.uniform(0, 15, T), etp=rng.uniform(0, 4, T))
    elif name == 'ABCModel':
        kw = dict(prec=rng.uniform(0, 15, T))
    elif name == 'HBVEdu':
        kw = dict(temp=rng.uniform(-5, 15, T), prec=rng.uniform(0, 10, T),
                  month=np.arange(T) % 12 + 1, PE_m=rng.uniform(0, 3, 12),
                  T_m=rng.uniform(-5, 15, 12), soil_init=100.0)
    else:
        mean_t = rng.uniform(-9, 13, T)
        kw = dict(prec=rng.uniform(0, 14, T), mean_temp=mean_t,
                  min_temp=mean_t - rng.uniform(0.5, 4, T),
                  max_temp=mean_t + rng.uniform(0.5, 4, T),
                  met_station_height=700,
                  altitudes=[550, 620, 700, 785, 920])
        if name != 'Cemaneige':
            kw['etp'] = rng.uniform(0, 3, T)
        if 'Ice' in name:
            kw['frac_ice'] = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    return getattr(models, name)(**CPU), obs, kw


def _assert_mesh_run_equal(got, want):
    """A mesh run against the run without one: the same population and
    best member, the energies at ``rtol=1e-12`` (see the module's
    docstring)."""
    np.testing.assert_array_equal(got.population, want.population)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_allclose(got.population_energies,
                               want.population_energies, rtol=1e-12)
    assert (got.nit, got.nfev) == (want.nit, want.nfev)


@pytest.mark.parametrize("name", CLASSES)
def test_fit_mesh_raises_not_implemented(name):
    """Every class's ``fit`` forwards ``mesh`` to DE: two CPU shards (each
    population of popsize 2 x dim is even) give the unsharded run, and
    what is not a mesh raises ``TypeError``.  The name predates the port
    of the mesh and is kept."""
    model, obs, kw = _fit_inputs(name)
    mesh = default_mesh(['cpu'] * 2)
    got = model.fit(obs, **kw, popsize=2, maxiter=2, seed=4, mesh=mesh)
    want = model.fit(obs, **kw, popsize=2, maxiter=2, seed=4)
    _assert_mesh_run_equal(got, want)
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        model.fit(obs, **kw, maxiter=1, mesh=object())


def test_fit_q_sca_mesh_raises_not_implemented():
    """``fit_Q_SCA`` forwards ``mesh`` too, as ``fit`` does above (the
    name predates the port of the mesh and is kept)."""
    model, obs, kw = _fit_inputs('CemaneigeHystGR4J')
    ndsi = {f'NDSI{i + 1}': np.full(len(obs), 50.0) for i in range(5)}
    mesh = default_mesh(['cpu'] * 2)
    got = model.fit_Q_SCA(obs, **kw, **ndsi, popsize=2, maxiter=2, seed=4,
                          mesh=mesh)
    want = model.fit_Q_SCA(obs, **kw, **ndsi, popsize=2, maxiter=2, seed=4)
    _assert_mesh_run_equal(got, want)
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        model.fit_Q_SCA(obs, **kw, **ndsi, maxiter=1, mesh=object())


@pytest.mark.parametrize("name", CLASSES)
def test_fit_checkpoint_resume_and_polish(name, tmp_path):
    """Every class's ``fit`` takes the checkpoint and polish keywords: two
    generations saved one by one, resumed to four and polished, walk the
    population of the unbroken four; the polish runs through the 'scan'
    engine, keeps a point no worse and counts its evaluations."""
    model, obs, kw = _fit_inputs(name)
    path = str(tmp_path / "fit.npz")
    full = model.fit(obs, **kw, seed=1, maxiter=4, tol=0.0)
    model.fit(obs, **kw, seed=1, maxiter=2, tol=0.0, checkpoint_path=path,
              checkpoint_every=1)
    resumed = model.fit(obs, **kw, seed=1, maxiter=4, tol=0.0,
                        resume_from=path, polish=True, polish_steps=2)
    assert resumed.nit == full.nit == 4
    np.testing.assert_array_equal(resumed.population, full.population)
    np.testing.assert_array_equal(resumed.population_energies,
                                  full.population_energies)
    assert resumed.fun <= full.fun
    assert resumed.nfev == full.nfev + 3        # the polish ran
    assert "skipped" not in resumed.message


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_checkpoint_resume_matches_uninterrupted(batched, tmp_path):
    """JAX's ``test_de_checkpoint_resume_matches_uninterrupted``, exact:
    15 generations saved every 5, then resumed to 40."""
    objective = _quadratic_batched if batched else _quadratic
    kw = dict(seed=7, tol=0.0, batched=batched, **CPU)
    full = differential_evolution(objective, BOUNDS, maxiter=40, **kw)
    path = str(tmp_path / "de.npz")
    part = differential_evolution(objective, BOUNDS, maxiter=15,
                                  checkpoint_path=path, checkpoint_every=5,
                                  **kw)
    assert part.nit == 15
    resumed = differential_evolution(objective, BOUNDS, maxiter=40,
                                     resume_from=path, **kw)
    assert resumed.nit == full.nit == 40
    _assert_same_run(resumed, full)


def test_chunked_equals_monolithic_and_saves_the_end(tmp_path):
    from rrmpg_tpu_torch.tools import load_checkpoint

    mono = differential_evolution(_quadratic, BOUNDS, seed=3, maxiter=30,
                                  tol=0.0, **CPU)
    path = str(tmp_path / "de.npz")
    chunked = differential_evolution(_quadratic, BOUNDS, seed=3, maxiter=30,
                                     tol=0.0, checkpoint_every=7,
                                     checkpoint_path=path, **CPU)
    _assert_same_run(mono, chunked)
    saved = load_checkpoint(path)
    assert int(saved['nit']) == 30 and saved['key'].dtype == np.uint8
    np.testing.assert_array_equal(saved['energies'],
                                  chunked.population_energies)


def test_jax_checkpoint_raises_on_resume(tmp_path):
    path = str(tmp_path / "jax_de.npz")
    jax_calibration.differential_evolution(_jax_quadratic, BOUNDS, seed=7,
                                           maxiter=5, tol=0.0,
                                           checkpoint_path=path)
    with pytest.raises(ValueError, match="JAX key cannot seed"):
        differential_evolution(_quadratic, BOUNDS, seed=7, maxiter=10,
                               resume_from=path, **CPU)


def test_checkpoint_of_another_population_raises(tmp_path):
    path = str(tmp_path / "de.npz")
    differential_evolution(_quadratic, BOUNDS, seed=7, maxiter=2,
                           checkpoint_path=path, **CPU)
    with pytest.raises(ValueError, match="population of shape"):
        differential_evolution(_quadratic, BOUNDS, popsize=10, maxiter=4,
                               resume_from=path, **CPU)


@pytest.mark.parametrize("where", ["checkpoint_path", "resume_from"])
@pytest.mark.parametrize("kind", ["new_path", "directory"])
def test_orbax_path_raises(where, kind, tmp_path):
    path = tmp_path / "ckpt"
    if kind == "directory":
        path.mkdir()
    with pytest.raises(NotImplementedError, match="Orbax is JAX-only"):
        differential_evolution(_quadratic, BOUNDS, maxiter=2,
                               **{where: str(path)}, **CPU)


# ---------------------------------------------------------------------------
# polish and gradient descent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_polish_never_worsens(batched):
    """JAX's ``test_de_polish_never_worsens``."""
    target = np.array([0.4, -0.7])
    bounds = [(-2, 2), (-2, 2)]

    def obj(x):
        t = torch.as_tensor(target, dtype=x.dtype)
        return ((x - t) ** 2).sum(-1)

    plain = differential_evolution(obj, bounds, seed=4, maxiter=5,
                                   batched=batched, **CPU)
    polished = differential_evolution(obj, bounds, seed=4, maxiter=5,
                                      batched=batched, polish=True, **CPU)
    assert polished.fun <= plain.fun
    assert polished.nfev == plain.nfev + 201   # 200 Adam steps + the end
    assert "Polished with gradient descent." in polished.message
    np.testing.assert_allclose(polished.x, target, atol=1e-3)
    np.testing.assert_array_equal(polished.population, plain.population)


def test_polish_of_an_objective_autograd_cannot_follow_is_skipped():
    def obj(x):
        return torch.as_tensor(float(_quadratic(x.detach())), dtype=x.dtype)

    plain = differential_evolution(obj, BOUNDS, seed=4, maxiter=3, **CPU)
    skipped = differential_evolution(obj, BOUNDS, seed=4, maxiter=3,
                                     polish=True, **CPU)
    assert skipped.message == plain.message + " Polish skipped (RuntimeError)."
    assert skipped.fun == plain.fun and skipped.nfev == plain.nfev
    np.testing.assert_array_equal(skipped.x, plain.x)


def _gd_pair(port_objective, jax_objective, bounds, x0, **kw):
    got = gradient_descent(port_objective, bounds, x0=x0, **kw, **CPU)
    want = jax_calibration.gradient_descent(jax_objective, bounds, x0=x0,
                                            **kw)
    return got, want


def test_gradient_descent_equals_jax_on_the_quadratic():
    x0 = np.array([3.0, 4.0])
    got, want = _gd_pair(_quadratic, _jax_quadratic, BOUNDS, x0, steps=300,
                         learning_rate=0.02)
    assert got.nit == want.nit == 300 and got.nfev == want.nfev == 301
    assert got.success and got.message == want.message
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=1e-8)
    np.testing.assert_allclose(got.fun, want.fun, rtol=1e-8, atol=1e-14)
    assert got.population.shape == (1, 2)


@pytest.mark.f64only
def test_gradient_descent_equals_jax_on_gr4j():
    """JAX's ``test_gradient_descent_refines_de_result`` objective: the MSE
    of a 300-step GR4J run, from one start in both packages."""
    rng = np.random.default_rng(6)
    prec, etp = rng.uniform(0, 15, 300), rng.uniform(0, 4, 300)
    truth = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    qobs = np.array(jax_run_gr4j(jnp.asarray(prec), jnp.asarray(etp), 0.3,
                                   0.3, truth)[0])
    p_t, e_t, q_t = (torch.as_tensor(a, dtype=F64) for a in (prec, etp,
                                                              qobs))

    def port(x):
        params = {k: x[i:i + 1] for i, k in enumerate(('x1', 'x2', 'x3',
                                                       'x4'))}
        return ((run_gr4j(p_t, e_t, 0.3, 0.3, params)[0][0] - q_t) ** 2
                ).mean()

    def ref(x):
        params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
        return jnp.mean((jax_run_gr4j(jnp.asarray(prec), jnp.asarray(etp),
                                      0.3, 0.3, params)[0]
                         - jnp.asarray(qobs)) ** 2)

    x0 = np.array([400.0, 0.5, 120.0, 1.8])
    got, want = _gd_pair(port, ref, GR4J_BOUNDS, x0, steps=60,
                         learning_rate=0.01)
    assert got.fun < float(ref(jnp.asarray(x0)))
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=1e-8)
    np.testing.assert_allclose(got.fun, want.fun, rtol=1e-8)


def test_gradient_descent_zeroes_nonfinite_gradients():
    """sqrt at 0 has an infinite gradient: the iterate stalls there in
    both packages instead of turning NaN."""
    def port(x):
        return torch.sqrt(x).sum()

    got, want = _gd_pair(port, lambda x: jnp.sqrt(x).sum(), [(0, 1)] * 2,
                         np.zeros(2), steps=5)
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    assert got.fun == want.fun == 0.0


def test_gradient_descent_random_start_within_bounds():
    res = gradient_descent(_quadratic, BOUNDS, seed=0, steps=800,
                           learning_rate=0.02, **CPU)
    assert res.success
    np.testing.assert_allclose(res.x, TARGET, atol=1e-2)


# ---------------------------------------------------------------------------
# random search
# ---------------------------------------------------------------------------

def _port_sample(generator, n):
    return torch.rand((n, 2), generator=generator, dtype=F64) * 6.0 - 3.0


def _jax_sample(key, n):
    return jax.random.uniform(key, (n, 2), minval=-3, maxval=3)


@pytest.mark.parametrize("batched", [False, True])
def test_random_search_reaches_jax_minimum(batched):
    kw = dict(batch_size=256, batched=batched) if batched else {}
    objective = (lambda X: (X ** 2).sum(1)) if batched else (
        lambda x: (x ** 2).sum())
    jax_objective = (lambda X: jnp.sum(X ** 2, axis=1)) if batched else (
        lambda x: jnp.sum(x ** 2))
    got = random_search(objective, _port_sample, 1024, seed=0, **kw, **CPU)
    want = jax_calibration.random_search(jax_objective, _jax_sample, 1024,
                                         seed=0, **kw)
    assert got.nfev == want.nfev == 1024 and got.nit == 1
    assert got.success and got.message == want.message
    assert got.fun < 0.05 and want.fun < 0.05
    np.testing.assert_allclose(got.x, np.zeros(2), atol=0.05 ** 0.5)
    np.testing.assert_allclose(got.fun, want.fun, atol=0.05)
    # The population fields hold the last batch.
    last = 256 if batched else 1024
    assert got.population.shape == (last, 2)
    assert got.population_energies.shape == (last,)


def test_random_search_counts_a_ragged_last_batch():
    res = random_search(lambda X: (X ** 2).sum(1), _port_sample, 1000,
                        seed=1, batch_size=300, batched=True, **CPU)
    assert res.nfev == 1000 and res.population.shape == (100, 2)


def test_random_search_all_nonfinite():
    res = random_search(lambda x: x.sum() * np.nan, _port_sample, 16,
                        seed=0, **CPU)
    assert not res.success and res.x is None and res.fun == np.inf
    assert res.message == ("Every sampled candidate produced a non-finite "
                           "loss.")
