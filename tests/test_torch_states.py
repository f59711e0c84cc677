"""PyTorch port: the forecast-mode state bundles against ``rrmpg_tpu``'s.

The same leaves, made with numpy from a seed, go through
``normalize_state`` / ``single_member_state`` / ``repair_state`` /
``check_state_type`` of both packages (``rrmpg_tpu_torch.interop`` hands one
state to both).  The functions only broadcast and clip, so the leaves must
be EQUAL, not close; error types and messages must be the reference's.
float64, CPU.
"""

import numpy as np
import pytest
import torch

from rrmpg_tpu.models import states as jax_states
from rrmpg_tpu.ops.gr4j import GR4JState as JaxGR4JState
from rrmpg_tpu_torch.interop import state_from_numpy, state_to_numpy
from rrmpg_tpu_torch.models import states
from rrmpg_tpu_torch.ops.gr4j import GR4JState

F64 = torch.float64
L, H = 3, 20

# bundle name -> core (unbatched) shape of every leaf, in field order
CORE_SHAPES = {
    "ABCState": ((),),
    "HBVEduState": ((),) * 4,
    "CemaneigeState": ((L,),) * 3,
    "CemaneigeHystState": ((L,),) * 5,
    "GR4JState": ((), (), (H,)),
}
FLAT = sorted(CORE_SHAPES)
NESTED = ["SnowGR4JState[CemaneigeState]",
          "SnowGR4JState[CemaneigeHystState]"]
ALL = FLAT + NESTED


def _jax_cls(name):
    return JaxGR4JState if name == "GR4JState" else getattr(jax_states, name)


def _leaves(name, batch, rng, physical):
    """Leaves of bundle ``name``; ``batch`` None (unbatched) or N."""
    lead = () if batch is None else (batch,)
    out = []
    for core in CORE_SHAPES[name]:
        x = rng.uniform(0.0 if physical else -2.0, 1.0 if physical else 3.0,
                        lead + core)
        out.append(x)
    if physical:
        fields = _jax_cls(name)._fields
        if "etg" in fields:
            out[fields.index("etg")] = -out[fields.index("etg")]
        if "swe_max" in fields:
            out[fields.index("swe_max")] = (out[fields.index("g")]
                                            + out[fields.index("swe_max")])
    return tuple(out)


def _pair(name, batch=None, seed=0, physical=True):
    """The same state as a (JAX bundle, torch bundle) pair."""
    rng = np.random.default_rng(seed)
    if name.startswith("SnowGR4JState"):
        snow_name = name[len("SnowGR4JState["):-1]
        snow = _leaves(snow_name, batch, rng, physical)
        gr4j = _leaves("GR4JState", batch, rng, physical)
        jax_state = jax_states.SnowGR4JState(
            snow=_jax_cls(snow_name)(*snow), gr4j=JaxGR4JState(*gr4j))
        torch_state = state_from_numpy("SnowGR4JState",
                                       ((snow_name, snow), gr4j), 'cpu', F64)
    else:
        leaves = _leaves(name, batch, rng, physical)
        jax_state = _jax_cls(name)(*leaves)
        torch_state = state_from_numpy(name, leaves, 'cpu', F64)
    return jax_state, torch_state


def _flat(state):
    """Every leaf of a (possibly nested) bundle of either package, as
    numpy."""
    if type(state).__name__ == "SnowGR4JState":
        return _flat(state.snow) + _flat(state.gr4j)
    return [np.asarray(x) for x in state]


def _assert_same(jax_state, torch_state):
    assert type(jax_state).__name__ == type(torch_state).__name__
    got, want = _flat(torch_state), _flat(jax_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch", [None, 1, 4])
@pytest.mark.parametrize("name", ALL)
def test_normalize_state_matches_jax(name, batch):
    jax_state, torch_state = _pair(name, batch, physical=False)
    got = states.normalize_state(torch_state, 4, F64, 'cpu')
    want = jax_states.normalize_state(jax_state, 4, np.float64)
    _assert_same(want, got)
    assert all(x.shape[0] == 4 for x in _flat(got))


@pytest.mark.parametrize("batch", [None, 1])
@pytest.mark.parametrize("name", ALL)
def test_single_member_state_matches_jax(name, batch):
    jax_state, torch_state = _pair(name, batch, seed=1, physical=False)
    got = states.single_member_state(torch_state, F64, 'cpu')
    want = jax_states.single_member_state(jax_state, np.float64)
    _assert_same(want, got)


@pytest.mark.parametrize("name", ALL)
def test_repair_state_matches_jax_and_is_idempotent(name):
    jax_state, torch_state = _pair(name, 5, seed=2, physical=False)
    got = states.repair_state(torch_state)
    _assert_same(jax_states.repair_state(jax_state), got)
    _assert_same(jax_states.repair_state(jax_state),
                 states.repair_state(got))
    assert states.is_repairable(torch_state)
    assert jax_states.is_repairable(jax_state)


@pytest.mark.parametrize("name", ALL)
def test_repair_state_is_bit_exact_on_physical_states(name):
    _, torch_state = _pair(name, 5, seed=3, physical=True)
    for before, after in zip(_flat(torch_state),
                             _flat(states.repair_state(torch_state))):
        assert before.tobytes() == after.tobytes()


def test_repair_state_clips_every_field_into_domain():
    st = states.CemaneigeHystState(
        g=torch.tensor([[-3.0, 5.0]]), etg=torch.tensor([[1.5, -2.0]]),
        sca=torch.tensor([[-0.2, 1.7]]), swe_max=torch.tensor([[-1.0, 2.0]]),
        psol_annual=torch.tensor([[-4.0, 8.0]]))
    rep = states.repair_state(st)
    np.testing.assert_array_equal(rep.g, [[0.0, 5.0]])
    np.testing.assert_array_equal(rep.etg, [[0.0, -2.0]])
    np.testing.assert_array_equal(rep.sca, [[0.0, 1.0]])
    # swe_max >= g: the coupling lifts 2.0 to the snowpack's 5.0
    np.testing.assert_array_equal(rep.swe_max, [[0.0, 5.0]])
    np.testing.assert_array_equal(rep.psol_annual, [[0.0, 8.0]])
    assert states.repair_state(None) is None
    nan = states.repair_state(GR4JState(
        s=torch.tensor([float('nan')]), r=torch.tensor([-1.0]),
        pr_history=torch.zeros(1, 2)))
    assert bool(torch.isnan(nan.s).all()) and float(nan.r) == 0.0


def _message(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("name", ALL)
def test_member_count_mismatch_message_matches_jax(name):
    jax_state, torch_state = _pair(name, 3)
    want = _message(jax_states.normalize_state, jax_state, 2, np.float64)
    got = _message(states.normalize_state, torch_state, 2, F64, 'cpu')
    assert got == want and got[0] is ValueError
    assert "leading state axis" in got[1]


@pytest.mark.parametrize("name", FLAT)
def test_wrong_ndim_message_matches_jax(name):
    rng = np.random.default_rng(4)
    leaves = tuple(rng.uniform(0, 1, (2, 2) + core)
                   for core in CORE_SHAPES[name])
    want = _message(jax_states.normalize_state, _jax_cls(name)(*leaves), 2,
                    np.float64)
    got = _message(states.normalize_state,
                   state_from_numpy(name, leaves, 'cpu', F64), 2, F64, 'cpu')
    assert got == want and "has ndim" in got[1]


@pytest.mark.parametrize("name", ALL)
def test_single_member_rejects_a_batch_like_jax(name):
    jax_state, torch_state = _pair(name, 3)
    want = _message(jax_states.single_member_state, jax_state, np.float64)
    got = _message(states.single_member_state, torch_state, F64, 'cpu')
    # The reference's hint names a JAX call; the port's names its own.  The
    # sentence up to the hint, with the leaf's name and shape, is the same.
    cut = "pass the state"
    assert got[0] is want[0] is ValueError
    assert got[1].split(cut)[0].replace("\n", " ") == \
        want[1].split(cut)[0].replace("\n", " ")
    assert "map_state" in got[1]


def test_check_state_type_messages_match_jax():
    jax_snow, torch_snow = _pair("SnowGR4JState[CemaneigeState]", 1)
    jax_hbv, torch_hbv = _pair("HBVEduState", 1)
    assert _message(states.check_state_type, torch_hbv, GR4JState,
                    "GR4J") == \
        _message(jax_states.check_state_type, jax_hbv, JaxGR4JState, "GR4J")
    assert _message(states.check_state_type, torch_snow,
                    states.SnowGR4JState, "CemaneigeHystGR4J",
                    snow_cls=states.CemaneigeHystState) == \
        _message(jax_states.check_state_type, jax_snow,
                 jax_states.SnowGR4JState, "CemaneigeHystGR4J",
                 snow_cls=jax_states.CemaneigeHystState)
    states.check_state_type(torch_snow, states.SnowGR4JState, "X",
                            snow_cls=states.CemaneigeState)
    assert _message(states.repair_state, object()) == \
        _message(jax_states.repair_state, object())
    assert not states.is_repairable(object())


@pytest.mark.parametrize("name", ALL)
def test_interop_round_trip(name):
    jax_state, torch_state = _pair(name, 2, seed=5)
    bundle, leaves = state_to_numpy(torch_state)
    again = state_from_numpy(bundle, leaves, 'cpu', F64)
    _assert_same(jax_state, again)
    assert type(again) is type(torch_state)
    with pytest.raises(TypeError, match="unknown state bundle"):
        state_from_numpy("NoSuchState", leaves, 'cpu', F64)


def test_leaves_land_on_the_asked_dtype_and_keep_numpy_input():
    """A bundle of numpy leaves (as ``load_state`` returns) is accepted, and
    the result is tensors of the asked dtype."""
    rng = np.random.default_rng(6)
    st = GR4JState(s=rng.uniform(0, 1, 2), r=rng.uniform(0, 1, 2),
                   pr_history=rng.uniform(0, 1, (2, 6)))
    out = states.normalize_state(st, 2, torch.float32, 'cpu')
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               for x in out)
    shared = states.broadcast_state(
        states.single_member_state(GR4JState(0.5, 0.25, np.zeros(6)), F64,
                                   'cpu'), 3)
    assert shared.pr_history.shape == (3, 6)
    assert shared.s.tolist() == [0.5, 0.5, 0.5]
    assert all(x.is_contiguous() for x in shared)


def test_state_helpers_default_to_the_card():
    """Like every entry point of the port, the state helpers put their
    tensors on the card unless told otherwise, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA path is not reachable")
    st = GR4JState(s=0.5, r=0.25, pr_history=np.zeros(6))
    leaves = (0.5, 0.25, np.zeros(6))
    for entry in (lambda: states.normalize_state(st, 2, F64),
                  lambda: states.single_member_state(st, F64),
                  lambda: state_from_numpy('GR4JState', leaves)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
