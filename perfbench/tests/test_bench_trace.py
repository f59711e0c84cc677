"""The trace's arithmetic and the metric readers on made-up events."""

import pytest
import torch

from perfbench.census import bound_s, gr4j
from perfbench.harness import Context, Window, _load_reader, resolve
from perfbench.tests.conftest import ROOT
from perfbench.trace import Tracer, merge

MS = 1_000_000


def fake_trace(events_by_device, spans):
    tracer = Tracer([torch.device("cuda", i) for i in events_by_device])
    tracer.events = events_by_device
    tracer.open_ns, tracer.close_ns = 0, 100 * MS
    tracer.window_s = 0.1
    tracer.spans = spans
    return tracer


def test_merge_and_busy():
    assert merge([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3], [5, 10]]
    tracer = fake_trace({0: [("k", 10 * MS, 50 * MS), ("c", 40 * MS,
                                                        60 * MS),
                             ("late", 90 * MS, 120 * MS)]}, [])
    assert tracer.busy_s(0) == pytest.approx(0.06)


def test_breakdown_names_idle_gaps_by_the_host_span():
    spans = [("draw", 0, 10 * MS), ("program", 10 * MS, 70 * MS)]
    tracer = fake_trace({0: [("kernel", 10 * MS, 60 * MS)],
                         1: [("kernel", 20 * MS, 100 * MS)]}, spans)
    out = tracer.breakdown()
    assert out["device_ops"] == [["kernel", pytest.approx(0.13)]]
    idle = dict(out["idle_gaps"])
    # Device 0: 0-10 (middle in draw), 60-100 (outside); device 1: 0-20
    # (middle at 10, in program).
    assert idle["draw"] == pytest.approx(0.01 / 2)
    assert idle["program"] == pytest.approx(0.02 / 2)
    assert idle["host outside the benchmark's spans"] == pytest.approx(0.02)


def test_readers_on_a_made_up_regional_trace():
    plan = resolve("gr4j.regional-mesh4", ROOT)
    tr = plan.traffic
    ops, n_bytes = gr4j.objective(tr["members"] // 2, 12418, (3, 7), True,
                                  catchments=tr["catchments"] // 2)
    launch = bound_s(ops, n_bytes) * 1e9 * 4      # at a quarter of it
    name = "void gr4j_regional_kernel<float, 3, 7, true, true>(...)"
    events = {i: [(name, 0, int(launch)), ("memcpy", int(launch),
                                           int(launch) + MS)]
              for i in range(4)}
    tracer = fake_trace(events, [])
    tracer.close_ns = int(launch) + 2 * MS
    tracer.window_s = tracer.close_ns / 1e9

    class FakeRun:
        days = 12418

        def member_day_ops(self):
            return gr4j.member_day_ops((3, 7), True)

    window = Window(tracer.window_s, 0, tracer.close_ns,
                    tr["catchments"] * tr["members"] * 12418, 1, [])
    ctx = Context(plan, FakeRun(), window, 5.0, 4, tracer)
    read = {m: _load_reader(ROOT, m)(ctx) for m in plan.readers}
    assert read["k5_roofline"] == pytest.approx(25.0)
    assert read["shard_spread"] == 0.0
    assert 0 < read["idle_share.eval"] < 0.05
    assert read["mfu.eval"] == pytest.approx(
        25.0 * launch / 1e9 / tracer.window_s, rel=1e-3)
    assert read["setup_s"] == 5.0


def test_a_roofline_is_none_without_a_launch_or_a_trace():
    plan = resolve("gr4j.mc-decade", ROOT)
    window = Window(1.0, 0, 10**9, 1, 1, [])
    run = type("FakeRun", (), {"days": 3651})()
    ctx = Context(plan, run, window, 1.0, 1, fake_trace({0: []}, []))
    assert _load_reader(ROOT, "k2_roofline")(ctx) is None
    ctx.trace = None
    assert _load_reader(ROOT, "k2_roofline")(ctx) is None
    assert _load_reader(ROOT, "idle_share.eval")(ctx) is None
