"""PyTorch port: state files (``tools/checkpoint.py``) against ``rrmpg_tpu``'s.

``save_state`` / ``load_state`` round-trip every bundle, and a file written
by either package loads in the other: the keys and the bundle tags are the
same.  The leaves travel as numpy arrays, so they must come back EQUAL.
"""

import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
from rrmpg_tpu.models import states as jax_states
from rrmpg_tpu.ops.gr4j import GR4JState as JaxGR4JState
from rrmpg_tpu.tools import checkpoint as jax_checkpoint
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.interop import state_from_numpy
from rrmpg_tpu_torch.models import states
from rrmpg_tpu_torch.tools import (load_checkpoint, load_state,
                                   save_checkpoint, save_state)

F64 = torch.float64
L, H, N = 3, 20, 2
CORE_SHAPES = {"ABCState": ((),), "HBVEduState": ((),) * 4,
               "CemaneigeState": ((L,),) * 3,
               "CemaneigeHystState": ((L,),) * 5,
               "GR4JState": ((), (), (H,))}
BUNDLES = sorted(CORE_SHAPES) + ["SnowGR4JState[CemaneigeState]",
                                 "SnowGR4JState[CemaneigeHystState]"]


def _jax_cls(name):
    return JaxGR4JState if name == "GR4JState" else getattr(jax_states, name)


def _pair(name, seed=0):
    """The same state as a (JAX bundle, torch bundle) pair."""
    rng = np.random.default_rng(seed)
    draw = lambda bundle: tuple(rng.uniform(0, 1, (N,) + core)
                                for core in CORE_SHAPES[bundle])
    if name.startswith("SnowGR4JState"):
        snow_name = name[len("SnowGR4JState["):-1]
        snow, gr4j = draw(snow_name), draw("GR4JState")
        return (jax_states.SnowGR4JState(snow=_jax_cls(snow_name)(*snow),
                                         gr4j=JaxGR4JState(*gr4j)),
                state_from_numpy("SnowGR4JState", ((snow_name, snow), gr4j),
                                 'cpu', F64))
    leaves = draw(name)
    return _jax_cls(name)(*leaves), state_from_numpy(name, leaves, 'cpu', F64)


def _leaves(state):
    if type(state).__name__ == "SnowGR4JState":
        return _leaves(state.snow) + _leaves(state.gr4j)
    return [np.asarray(x) for x in state]


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    if type(a).__name__ == "SnowGR4JState":
        assert type(a.snow).__name__ == type(b.snow).__name__
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", BUNDLES)
def test_state_round_trip(tmp_path, name):
    _, state = _pair(name)
    path = tmp_path / "state.npz"
    save_state(path, state)
    back = load_state(path)
    assert type(back) is type(state)
    _assert_same(back, state)
    assert all(isinstance(x, np.ndarray) for x in _leaves(back))


@pytest.mark.parametrize("name", BUNDLES)
def test_file_written_by_jax_loads_in_the_port(tmp_path, name):
    jax_state, state = _pair(name, seed=1)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_state(path, jax_state)
    back = load_state(path)
    assert type(back) is type(state)
    _assert_same(back, state)


@pytest.mark.parametrize("name", BUNDLES)
def test_file_written_by_the_port_loads_in_jax(tmp_path, name):
    jax_state, state = _pair(name, seed=2)
    path = str(tmp_path / "torch.npz")
    save_state(path, state)
    back = jax_checkpoint.load_state(path)
    assert type(back) is type(jax_state)
    _assert_same(back, jax_state)


def test_keys_and_tags_are_the_reference_s(tmp_path):
    jax_state, state = _pair("SnowGR4JState[CemaneigeHystState]", seed=3)
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_state(ours, state)
    jax_checkpoint.save_state(theirs, jax_state)
    a, b = load_checkpoint(ours), jax_checkpoint.load_checkpoint(theirs)
    assert sorted(a) == sorted(b)
    assert "snow.swe_max" in a and "gr4j.pr_history" in a
    assert {k: str(v) for k, v in a["metadata"].items()} == \
        {"bundle": "SnowGR4JState", "snow_bundle": "CemaneigeHystState"}
    assert {k: str(v) for k, v in b["metadata"].items()} == \
        {k: str(v) for k, v in a["metadata"].items()}


def test_checkpoint_round_trip_and_errors(tmp_path):
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, {"population": torch.arange(6.0).reshape(2, 3),
                           "best": np.float64(0.25)},
                    metadata={"generation": 7, "note": "resume"})
    data = load_checkpoint(path)
    np.testing.assert_array_equal(data["population"],
                                  np.arange(6.0).reshape(2, 3))
    assert int(data["metadata"]["generation"]) == 7
    assert str(data["metadata"]["note"]) == "resume"
    assert not list(tmp_path.glob("*.tmp"))          # atomic replacement
    with pytest.raises(TypeError, match="expects a state bundle"):
        save_state(path, {"s": 1.0})
    with pytest.raises(ValueError, match="does not hold a state bundle"):
        load_state(path)


def test_forecast_cycle_through_a_file(tmp_path):
    """The operational cycle: spin up, store the state, load it, continue
    -- in the port, and from the port's file in ``rrmpg_tpu``."""
    rng = np.random.default_rng(4)
    prec, etp = rng.uniform(0, 15, 90), rng.uniform(0, 4, 90)
    p = {'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3}
    model = models.GR4J(params=p, device='cpu', dtype=F64)
    full = model.simulate(prec, etp, s_init=0.3, r_init=0.5)
    _, st = model.simulate(prec[:50], etp[:50], s_init=0.3, r_init=0.5,
                           return_final_state=True, engine='fused')
    path = str(tmp_path / "gr4j.npz")
    save_state(path, st)
    for engine in ('scan', 'fused'):
        q_b = model.simulate(prec[50:], etp[50:],
                             initial_state=load_state(path), engine=engine)
        np.testing.assert_allclose(q_b.numpy(), full[50:].numpy(),
                                   rtol=1e-10, atol=1e-12)
    q_jax = jax_models.GR4J(params=p).simulate(
        prec[50:], etp[50:], initial_state=jax_checkpoint.load_state(path))
    np.testing.assert_allclose(np.asarray(q_jax), full[50:].numpy(),
                               rtol=1e-9, atol=1e-11)
    res = model.fit(full[50:, 0].numpy(), prec[50:], etp[50:],
                    initial_state=load_state(path), seed=0, maxiter=3,
                    engine='fused')
    assert np.isfinite(res.fun)
