"""PyTorch port, the public names of the JAX package (CPU, float64).

Every name ``rrmpg_tpu.ops`` exports and every name in
``rrmpg_tpu.models.__all__`` has its counterpart in the port (none is left
out since the Toeplitz scan was ported).  Every name
``rrmpg_tpu.tools`` exports imports from ``rrmpg_tpu_torch.tools`` but for
the tools that wait for ROADMAP Queue 1 item 8 (listed, with their letter,
and held to still be missing, so that the list stays true; none wait now).  Every name
``rrmpg_tpu.utils`` imports has its counterpart in ``rrmpg_tpu_torch.utils``, and every
name ``rrmpg_tpu.parallel`` imports in ``rrmpg_tpu_torch.parallel`` (JAX's
``relaxed_shard_map``, JAX-specific, is left out on purpose).  The cold
:class:`GR4JState` of ``gr4j_initial_state`` equals JAX's member by member,
and a warm start from it is ``run_gr4j``, in the port and against JAX's,
at ``rtol=1e-12``: the two packages run the same float64 equations, whose
measured differences are ~1e-13.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
import rrmpg_tpu.ops as jax_ops
import rrmpg_tpu.parallel as jax_parallel
import rrmpg_tpu.tools as jax_tools
import rrmpg_tpu.utils as jax_utils
from rrmpg_tpu.ops import gr4j as jax_gr4j
from rrmpg_tpu_torch import models, ops, parallel, tools, utils
from rrmpg_tpu_torch.interop import params_from_numpy
from rrmpg_tpu_torch.ops import gr4j as pt_gr4j

torch.set_num_threads(1)

RTOL = 1e-12
# Not ported on purpose: none since the Toeplitz scan behind ABC's 'scan'
# engine (``linear_recurrence``, ``run_abcmodel_matscan``) was ported.
NOT_PORTED = ()
# The Pallas wrappers' counterparts are the fused CUDA wrappers, named
# ``*_fused`` but for these.
PALLAS_COUNTERPARTS = {
    "gr4j_regional_mse_pallas": "gr4j_regional_objective_fused",
    "abc_fused_pallas": "abc_fused",
    "abc_fused_single_pallas": "abc_fused_single",
}


# Tools of the JAX package that wait for ROADMAP Queue 1 item 8, by its
# letter: not left out on purpose.  None wait now (the four assimilation
# tools of 8f were the last).
TOOLS_WAITING = {}


def _imported_names(module):
    """The names ``module``'s ``__init__.py`` imports (neither package's
    ``ops`` nor ``tools`` has an ``__all__``)."""
    tree = ast.parse(inspect.getsource(module))
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


def _jax_ops_names():
    return _imported_names(jax_ops)


def _counterpart(name):
    if name.endswith("_pallas"):
        return PALLAS_COUNTERPARTS.get(
            name, name[:-len("_pallas")] + "_fused")
    return name


@pytest.mark.parametrize(
    "name", [n for n in _jax_ops_names() if n not in NOT_PORTED])
def test_ops_name_has_its_counterpart(name):
    assert hasattr(ops, _counterpart(name))


@pytest.mark.parametrize("name", sorted(jax_models.__all__))
def test_models_name_is_exported(name):
    assert name in models.__all__
    assert getattr(models, name) is not None


@pytest.mark.parametrize("name", _imported_names(jax_tools))
def test_tools_name_imports_unless_waiting(name):
    if name in TOOLS_WAITING:
        assert not hasattr(tools, name), (
            f"{name} is ported: take it off TOOLS_WAITING")
    else:
        assert getattr(tools, name) is not None
        assert name in _imported_names(tools)


# JAX's shard_map across jax versions: JAX-specific, not ported on purpose.
PARALLEL_NOT_PORTED = ("relaxed_shard_map",)


@pytest.mark.parametrize("name", _imported_names(jax_parallel))
def test_parallel_name_has_its_counterpart(name):
    """Every name ``rrmpg_tpu.parallel`` exports, from the mesh helpers to
    ``initialize``, imports from ``rrmpg_tpu_torch.parallel``."""
    assert name not in PARALLEL_NOT_PORTED
    assert getattr(parallel, name) is not None
    assert name in _imported_names(parallel)


def test_parallel_leaves_out_relaxed_shard_map():
    assert not any(hasattr(parallel, n) for n in PARALLEL_NOT_PORTED)


@pytest.mark.parametrize("name", _imported_names(jax_utils))
def test_utils_name_has_its_counterpart(name):
    assert getattr(utils, name) is not None
    assert name in _imported_names(utils)


def test_tools_waiting_names_are_jax_tools():
    assert set(TOOLS_WAITING) <= set(_imported_names(jax_tools))


def test_models_all_names_resolve():
    for name in models.__all__:
        assert hasattr(models, name), name


def test_f4_names_import():
    from rrmpg_tpu_torch.ops import (  # noqa: F401
        gr4j_initial_state, run_cemaneigegr4j_warm,
        run_cemaneigehystgr4j_warm)


def _members(seed):
    rng = np.random.default_rng(seed)
    return {'x1': rng.uniform(100, 1200, 3), 'x2': rng.uniform(-5, 3, 3),
            'x3': rng.uniform(20, 300, 3), 'x4': rng.uniform(1.1, 9.9, 3)}


@pytest.mark.f64only
def test_gr4j_initial_state_matches_jax():
    params = _members(11)
    s_init, r_init = 0.4, 0.6
    state = pt_gr4j.gr4j_initial_state(
        s_init, r_init, params_from_numpy(params, device='cpu',
                                          dtype=torch.float64),
        device='cpu')
    assert state.s.shape == state.r.shape == (3,)
    assert state.pr_history.shape == (3, 20)
    assert state.s.dtype == torch.float64
    for k in range(3):
        want = jax_gr4j.gr4j_initial_state(
            s_init, r_init, {p: v[k] for p, v in params.items()},
            dtype=jnp.float64)
        for got, ref in zip(state, want):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=0.0)


def test_gr4j_initial_state_scalars_and_uh_length():
    state = pt_gr4j.gr4j_initial_state(0.3, 0.5, {'x1': 200.0, 'x3': 40.0},
                                       num_uh2=7, dtype=torch.float64,
                                       device='cpu')
    assert state.s.shape == state.r.shape == ()
    assert float(state.s) == 60.0 and float(state.r) == 20.0
    assert state.pr_history.shape == (6,)
    assert not bool(state.pr_history.any())


def test_gr4j_initial_state_lands_on_the_default_device(monkeypatch):
    seen = []
    monkeypatch.setattr(pt_gr4j, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    pt_gr4j.gr4j_initial_state(0.3, 0.5, {'x1': 200.0, 'x3': 40.0})
    assert seen == ["cuda"]


@pytest.mark.f64only
def test_gr4j_warm_from_initial_state_is_run_gr4j():
    rng = np.random.default_rng(3)
    prec, etp = rng.uniform(0, 15, 500), rng.uniform(0, 4, 500)
    params = _members(5)
    p64 = params_from_numpy(params, device='cpu', dtype=torch.float64)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    s_init, r_init = 0.4, 0.6
    cold = pt_gr4j.run_gr4j(as_t(prec), as_t(etp), s_init, r_init, p64)
    state = pt_gr4j.gr4j_initial_state(s_init, r_init, p64, device='cpu')
    warm = pt_gr4j.run_gr4j_warm(as_t(prec), as_t(etp), state, p64)[:3]
    jax_cold = jax.vmap(lambda p: jax_gr4j.run_gr4j(
        jnp.asarray(prec), jnp.asarray(etp), s_init, r_init, p))(
            {k: jnp.asarray(v) for k, v in params.items()})
    for got, port, ref in zip(warm, cold, jax_cold):
        np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=RTOL,
                                   atol=0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=0.0)
