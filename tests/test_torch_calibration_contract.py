"""PyTorch port, the calling contracts of DE and of ``mesh=`` against the
JAX package (CPU).

* ``differential_evolution(..., batched=False)`` maps a per-member
  ``(dim,) -> scalar`` objective over the population, as
  ``rrmpg_tpu.tools.calibration.differential_evolution`` does by default;
  ``batched=True`` takes a ``(P, dim) -> (P,)`` objective; energies of any
  other shape raise ``ValueError``.  The two packages draw different
  random numbers, so they are compared by the minimum they reach, not by
  their trajectories: both must land within ``atol=0.05`` of the
  quadratic's minimizer with a loss below ``1e-3``.
* ``mesh=`` stands where JAX has it (``simulate`` of every class,
  ``monte_carlo``'s fourth parameter); ``None`` runs, a
  :class:`rrmpg_tpu_torch.parallel.Mesh` runs sharded
  (``tests/test_torch_parallel.py``), anything else raises ``TypeError``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu.tools.calibration import \
    differential_evolution as jax_differential_evolution
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.tools import differential_evolution, monte_carlo

torch.set_num_threads(1)

F64 = torch.float64
TARGET = np.array([1.0, -2.0, 3.0])
BOUNDS = [(-5.0, 5.0), (-5.0, 5.0), (0.0, 10.0)]
CLASSES = ('GR4J', 'HBVEdu', 'ABCModel', 'Cemaneige', 'CemaneigeGR4J',
           'CemaneigeGR4JIce', 'CemaneigeHystGR4J', 'CemaneigeHystGR4JIce')


def _quadratic(x):
    """One member: (dim,) -> scalar."""
    return ((x - torch.as_tensor(TARGET, dtype=x.dtype)) ** 2).sum()


def _quadratic_batched(X):
    """The population: (P, dim) -> (P,)."""
    return ((X - torch.as_tensor(TARGET, dtype=X.dtype)) ** 2).sum(1)


def _jax_minimum():
    res = jax_differential_evolution(
        lambda x: jnp.sum((x - jnp.asarray(TARGET)) ** 2), BOUNDS, seed=3)
    return np.asarray(res.x), float(res.fun)


@pytest.mark.parametrize("batched", [False, True])
def test_de_reaches_jax_minimum(batched):
    want_x, want_fun = _jax_minimum()
    res = differential_evolution(
        _quadratic_batched if batched else _quadratic, BOUNDS, seed=3,
        batched=batched, device='cpu', dtype=F64)
    assert res.success and res.fun < 1e-3 and want_fun < 1e-3
    np.testing.assert_allclose(res.x, TARGET, atol=0.05)
    np.testing.assert_allclose(res.x, want_x, atol=0.05)
    assert res.population.shape == (45, 3)
    assert res.nfev == 45 * (res.nit + 1)


def test_de_per_member_default_equals_batched_run():
    """The default form maps the same objective the batched form takes
    whole: with one seed both walk the same population."""
    a = differential_evolution(_quadratic, BOUNDS, seed=5, maxiter=20,
                               device='cpu', dtype=F64)
    b = differential_evolution(_quadratic_batched, BOUNDS, seed=5,
                               maxiter=20, batched=True, device='cpu',
                               dtype=F64)
    np.testing.assert_allclose(a.population, b.population, rtol=1e-12)
    np.testing.assert_allclose(a.population_energies, b.population_energies,
                               rtol=1e-12)
    assert a.nit == b.nit


def test_de_per_member_objective_vmap_cannot_trace():
    """A per-member objective that leaves the tensor world (``float(...)``)
    cannot be vmapped; it is evaluated member by member instead."""
    def objective(x):
        return float(((x.numpy() - TARGET) ** 2).sum())

    res = differential_evolution(objective, BOUNDS, seed=3, device='cpu',
                                 dtype=F64)
    assert res.fun < 1e-3
    np.testing.assert_allclose(res.x, TARGET, atol=0.05)


@pytest.mark.parametrize("batched,objective", [
    (True, lambda X: X.sum()),                    # one number, not (P,)
    (True, lambda X: X.sum(1, keepdim=True)),     # (P, 1)
    (False, lambda x: x * 2.0),                   # (dim,) per member
    (False, lambda x: x.sum(0, keepdim=True)),    # (1,) per member
])
def test_de_energies_of_another_shape_raise(batched, objective):
    with pytest.raises(ValueError, match=r"expected \(45,\)"):
        differential_evolution(objective, BOUNDS, seed=0, maxiter=2,
                               batched=batched, device='cpu', dtype=F64)


def test_de_population_objective_needs_batched():
    """The pre-contract call, a population objective without ``batched``,
    now fails loudly instead of reading one number as converged."""
    with pytest.raises(ValueError, match="batched=True"):
        differential_evolution(lambda x: x.sum() * torch.ones(4), BOUNDS,
                               seed=0, device='cpu', dtype=F64)


@pytest.mark.parametrize("name", CLASSES)
def test_simulate_signature_matches_jax(name):
    """Every parameter of the JAX class's ``simulate`` but ``interpret``
    (Pallas' interpret mode), in JAX's order: ``mesh`` stands where JAX
    has it."""
    want = [p for p in inspect.signature(
        getattr(jax_models, name).simulate).parameters if p != 'interpret']
    got = list(inspect.signature(getattr(models, name).simulate).parameters)
    assert got == want
    assert 'mesh' in got


def test_monte_carlo_signature_matches_jax():
    want = list(inspect.signature(jax_monte_carlo).parameters)
    got = list(inspect.signature(monte_carlo).parameters)
    assert got == want
    assert got[3] == 'mesh'


def _gr4j_inputs(T=60):
    rng = np.random.default_rng(0)
    return rng.uniform(0, 15, T), rng.uniform(0, 4, T), rng.uniform(0, 5, T)


def _hbv_inputs(T=60):
    rng = np.random.default_rng(1)
    return dict(temp=rng.uniform(-5, 15, T), prec=rng.uniform(0, 10, T),
                month=np.arange(T) % 12 + 1,
                PE_m=rng.uniform(0, 3, 12), T_m=rng.uniform(-5, 15, 12))


PARAMS = {
    'GR4J': {'x1': 300.0, 'x2': 0.5, 'x3': 80.0, 'x4': 2.0},
    'HBVEdu': {'T_t': 0.0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
               'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
               'K_p': 0.05, 'L': 4.87},
    'ABCModel': {'a': 0.3, 'b': 0.2, 'c': 0.15},
}


def _simulate(package, name, **mesh):
    """``name``'s simulate with ``PARAMS[name]`` in ``package`` (the port
    on the CPU in float64, or the JAX package)."""
    kw = dict(device='cpu', dtype=F64) if package is models else {}
    model = getattr(package, name)(params=PARAMS[name], **kw)
    prec, etp, _ = _gr4j_inputs()
    if name == 'GR4J':
        return model.simulate(prec, etp, **mesh)
    if name == 'HBVEdu':
        return model.simulate(**_hbv_inputs(), soil_init=100.0, **mesh)
    return model.simulate(prec, **mesh)


@pytest.mark.parametrize("name", ['GR4J', 'HBVEdu', 'ABCModel'])
def test_simulate_mesh_none_runs_and_equals_jax(name):
    got = _simulate(models, name, mesh=None)
    want = _simulate(jax_models, name, mesh=None)
    assert got.shape == (60, 1) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("name", ['GR4J', 'HBVEdu', 'ABCModel'])
def test_simulate_mesh_raises_not_implemented(name):
    """Since the mesh is ported, what is not a mesh raises ``TypeError``
    (a mesh runs: ``tests/test_torch_parallel.py``).  The name predates
    the port of the mesh and is kept."""
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        _simulate(models, name, mesh=object())


def test_monte_carlo_positional_mesh_like_jax():
    """``monte_carlo(model, n, qobs, None)``: the fourth positional
    argument is the mesh, as in JAX, so the metrics keep their default."""
    prec, etp, qobs = _gr4j_inputs()
    np.random.seed(3)
    got = monte_carlo(models.GR4J(device='cpu', dtype=F64), 8, qobs, None,
                      prec=prec, etp=etp)
    np.random.seed(3)
    want = jax_monte_carlo(jax_models.GR4J(), 8, qobs, None, prec=prec,
                           etp=etp)
    assert sorted(got) == sorted(want) == ['mse', 'params', 'qsim']
    np.testing.assert_allclose(got['mse'], want['mse'], rtol=1e-10)


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_monte_carlo_mesh_raises_not_implemented(engine):
    """Since the mesh is ported, what is not a mesh raises ``TypeError``
    before any sampling (a mesh runs: ``tests/test_torch_parallel.py``).
    The name predates the port of the mesh and is kept."""
    prec, etp, qobs = _gr4j_inputs()
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        monte_carlo(models.GR4J(device='cpu', dtype=F64), 8, qobs, object(),
                    prec=prec, etp=etp, engine=engine, return_qsim=False)
