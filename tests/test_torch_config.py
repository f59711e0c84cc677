"""PyTorch port, ``config.enable_x64`` / ``config.default_float`` (CPU).

The counterparts of ``rrmpg_tpu.config``: a process-wide default float
type, float32 until ``enable_x64()``.  Every entry point's ``dtype=None``
resolves to it when called, so after ``enable_x64()`` a call without
``dtype`` equals the same call with ``dtype=torch.float64`` bit for bit,
and an explicit ``dtype`` still wins.  The ``x64`` fixture restores the
flag, as the xdist workers run many test files in one process.
"""

import inspect

import numpy as np
import pytest
import torch

import rrmpg_tpu.config as jax_config
from rrmpg_tpu_torch import config, interop, models, ops, tools

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


@pytest.fixture
def x64():
    before = config.default_float()
    config.enable_x64()
    yield
    config.enable_x64(before == F64)


def test_config_names_match_jax():
    for name in ("enable_x64", "default_float"):
        assert (list(inspect.signature(getattr(config, name)).parameters)
                == list(inspect.signature(getattr(jax_config,
                                                  name)).parameters))


def test_default_is_float32_and_the_flag_switches_back():
    assert config.default_float() == F32 == config.resolve_dtype(None)
    try:
        config.enable_x64()
        assert config.default_float() == F64 == config.resolve_dtype(None)
        assert config.resolve_dtype(F32) == F32
        config.enable_x64(False)
        assert config.default_float() == F32
    finally:
        config.enable_x64(False)


def _gr4j_inputs():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 15, 200), rng.uniform(0, 4, 200)


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_model_without_dtype_is_float64_bit_for_bit(x64, engine):
    prec, etp = _gr4j_inputs()
    params = {'x1': 300.0, 'x2': 0.5, 'x3': 80.0, 'x4': 1.7}
    model = models.GR4J(params=params, device='cpu')
    assert model.dtype == F64
    got = model.simulate(prec, etp, engine=engine)
    want = models.GR4J(params=params, device='cpu',
                       dtype=F64).simulate(prec, etp, engine=engine)
    assert got.dtype == F64
    assert torch.equal(got, want)
    explicit = models.GR4J(params=params, device='cpu', dtype=F32)
    assert explicit.simulate(prec, etp, engine=engine).dtype == F32


def test_class_made_before_the_switch_keeps_its_dtype():
    model = models.ABCModel(device='cpu')
    try:
        config.enable_x64()
        assert model.dtype == F32
        assert model.simulate(np.ones(10)).dtype == F32
        assert models.ABCModel(device='cpu').dtype == F64
    finally:
        config.enable_x64(False)


def _quadratic(x):
    return ((x - 0.25) ** 2).sum()


@pytest.mark.parametrize("tool", ["differential_evolution", "sce_ua",
                                  "random_search"])
def test_tools_without_dtype_are_float64_bit_for_bit(x64, tool):
    bounds = [(-1.0, 1.0)] * 2
    if tool == "random_search":
        def call(**kw):
            return tools.random_search(
                _quadratic, lambda g, n: torch.rand(
                    (n, 2), generator=g, dtype=F64), 64, seed=2,
                device='cpu', **kw)
    else:
        def call(**kw):
            return getattr(tools, tool)(_quadratic, bounds, seed=2,
                                        maxiter=3, device='cpu', **kw)
    got, want = call(), call(dtype=F64)
    assert got.population.dtype == np.float64
    np.testing.assert_array_equal(got.population, want.population)
    np.testing.assert_array_equal(got.population_energies,
                                  want.population_energies)
    assert got.fun == want.fun


def test_ops_and_interop_without_dtype_are_float64(x64):
    state = ops.gr4j_initial_state(0.3, 0.5, {'x1': 200, 'x3': 40},
                                   device='cpu')
    assert state.s.dtype == F64
    params = interop.params_from_numpy({'x1': [200.0]}, device='cpu')
    assert params['x1'].dtype == F64
    assert interop.params_from_numpy({'x1': [200.0]}, device='cpu',
                                     dtype=F32)['x1'].dtype == F32


def test_without_the_switch_nothing_changes():
    prec, etp = _gr4j_inputs()
    assert models.GR4J(device='cpu').dtype == F32
    assert interop.params_from_numpy({'x1': [1.0]},
                                     device='cpu')['x1'].dtype == F32
    res = tools.differential_evolution(_quadratic, [(-1, 1)] * 2, seed=0,
                                       maxiter=2, device='cpu')
    assert res.population.dtype == np.float32
