"""What decides ``correct``, at sizes a CPU test run holds: a sound run
passes its limits, the control (the reference in bfloat16 in the
program's place) fails one, and the rest of a run, driven with the timed
path broken underneath, comes out not correct for each fault the cell can
have."""

import pytest

from perfbench.control import readings
from perfbench.faults import applicable, planted
from perfbench.harness import execute
from perfbench.tests.conftest import SMALL, cpu_devices

SEED = 2 ** 31 + 11


def over_limit(gaps, limits):
    return any(v > limits[k] for k, v in gaps.items())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_passes_and_control_fails(name, small_plan):
    plan = small_plan(name)
    row = readings(plan, cpu_devices(plan), SEED, 0.05, control=True)
    assert not over_limit(row["program"], plan.limits), row
    assert over_limit(row["control"], plan.limits), row


def _cases():
    from perfbench.harness import resolve
    from perfbench.tests.conftest import ROOT

    return [(name, fault) for name in sorted(SMALL)
            for fault in applicable(resolve(name, ROOT))]


@pytest.mark.parametrize("name, fault", _cases())
def test_broken_timed_path_is_not_correct(name, fault, small_plan):
    plan = small_plan(name)
    with planted(fault, plan):
        result = execute(plan, cpu_devices(plan), SEED, 0.05)
    assert result["correct"] is False, result["checks"]
