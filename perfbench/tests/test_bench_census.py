"""The frozen census against the bounds of PERF.md's kernel table (the
table's shapes, float32, the card's published peaks)."""

import pytest

from perfbench.census import bound_s, gr4j, snow

N, T = 131072, 3651


@pytest.mark.parametrize("ops_bytes, table_ms", [
    (gr4j.objective(N, T, (10, 21), False), 0.814),          # K1
    (gr4j.objective(N, T, (10, 21), True), 0.850),           # K2
    (gr4j.objective(N, T, (10, 21), False, catchments=8), 6.514),   # K5
    (gr4j.objective(N, T, (3, 7), False, catchments=8), 4.114),
    (gr4j.objective(N, 12418, (10, 21), False, catchments=8), 22.156),
    (snow.objective(N, T, 5, True, True, (3, 7), True), 1.921),     # K8
], ids=["K1", "K2", "K5", "K5 (3, 7)", "K5 12418 days", "K8 stats"])
def test_census_matches_the_kernel_table(ops_bytes, table_ms):
    assert bound_s(*ops_bytes) * 1e3 == pytest.approx(table_ms, abs=6e-4)


def test_step_counts():
    assert gr4j.step_ops((3, 7)) == 69 and gr4j.step_ops((10, 21)) == 111
    assert snow.member_day_ops(5, True, True, (3, 7)) == 269
