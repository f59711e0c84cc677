"""Shared helpers of the benchmark's own tests (CPU; the card's test is
marked ``cuda`` and skips without one)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes a CPU test run holds; the loops and the program's plain versions
# run as on the card.
SMALL = {
    "gr4j.mc-decade": dict(members=256, days=200, checked=64),
    "snow.mc-decade": dict(members=128, days=200, checked=64),
    "gr4j.fit-camels": dict(popsize=3, maxiter=40, days=365),
    "gr4j.regional-mesh4": dict(catchments=4, members=8, checked=8),
}


@pytest.fixture
def small_plan():
    from perfbench.harness import resolve

    def make(name):
        plan = resolve(name, ROOT)
        plan.traffic.update(SMALL[name])
        return plan

    return make


def cpu_devices(plan):
    import torch

    return [torch.device("cpu")] * plan.workload["chips"]
