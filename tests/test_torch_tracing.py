"""PyTorch port, its spans and counters (CPU).

``rrmpg_tpu_torch.utils.tracing`` records spans only inside a
``torch.profiler`` session and counts launches and host syncs always.
These tests hold its recording rules (the no-op outside a session, parent
and root ids, the cap), the launch counts' one home, and the spans and
syncs of a small DE fit and of a regional objective on a 4-shard CPU mesh,
whose results stay bit for bit those of an untraced run.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import _launch
from rrmpg_tpu_torch.ops import fused_gr4j
from rrmpg_tpu_torch.parallel import (ensemble_catchment_mesh,
                                      regional_gr4j_objective)
from rrmpg_tpu_torch.utils import tracing
from rrmpg_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def host_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_nothing_is_recorded_without_a_profiler_session():
    first = tracing.span("a", device="cpu")
    assert first is tracing.span("b")
    with first:
        with tracing.span("c"):
            pass
    assert tracing.sync("site", int, torch.tensor(3)) == 3
    assert tracing.spans() == []
    # Counters count with or without a session.
    assert tracing.counters()["syncs"] == {"site": 1}


def test_spans_nest_with_parent_and_root_ids():
    with host_profiler():
        assert tracing.span("a") is not tracing.span("b")
        with tracing.span("outer", device="cpu"):
            with tracing.span("inner", shard=1):
                tracing.annotate(kernel="k")
                tracing.sync("read", float, torch.tensor(2.0))
            with tracing.span("second"):
                pass
        with tracing.span("next root"):
            pass
    assert tracing.span("a") is tracing.span("b")
    spans = {s["name"]: s for s in tracing.spans()}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert inner["parent"] == outer["id"] and inner["root"] == outer["id"]
    assert spans["sync"]["parent"] == inner["id"]
    assert spans["sync"]["root"] == outer["id"]
    assert spans["sync"]["attrs"] == {"site": "read"}
    assert spans["second"]["parent"] == outer["id"]
    assert spans["next root"]["root"] == spans["next root"]["id"] != \
        outer["root"]
    assert inner["attrs"] == {"shard": 1, "kernel": "k"}
    assert outer["attrs"] == {"device": "cpu"}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    assert [s["name"] for s in tracing.spans()] == [
        "outer", "inner", "sync", "second", "next root"]


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with host_profiler():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [s["name"] for s in tracing.spans()] == ["s0", "s1", "s2"]
    assert tracing.counters()["spans_dropped"] == 2
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters()[
        "spans_dropped"] == 0


def test_launch_counts_live_in_tracing():
    assert _launch.LAUNCHES is tracing.LAUNCHES
    assert fused_gr4j.LAUNCHES is tracing.LAUNCHES
    assert _launch.reset_launches is tracing.reset_launches
    assert _launch.register_kernels is tracing.register_kernels
    assert "gr4j_mse" in tracing.counters()["launches"]


def test_to_device_counts_only_copies_to_a_card():
    x = tracing.to_device("copy", [1.0, 2.0], torch.float64, "cpu")
    assert x.dtype == torch.float64 and tracing.counters()["syncs"] == {}


def fit_inputs(days=365):
    frame = CAMELSLoader().load_basin("01031500")[:days]
    return tuple(frame[c].to_numpy(np.float64)
                 for c in ("QObs(mm/d)", "prcp(mm/day)", "PET"))


def test_a_fit_records_its_generations_and_syncs():
    qobs, prec, etp = fit_inputs()
    model = GR4J(device="cpu", dtype=torch.float64)
    kw = dict(seed=11, engine="scan", popsize=5, maxiter=5, tol=0)
    plain = model.fit(qobs, prec, etp, **kw)
    assert tracing.spans() == []
    tracing.reset()
    with host_profiler():
        traced = model.fit(qobs, prec, etp, **kw)
    assert np.array_equal(traced.population, plain.population)
    assert np.array_equal(traced.population_energies,
                          plain.population_energies)
    assert traced.fun == plain.fun and traced.nit == plain.nit == 5

    spans = tracing.spans()
    (fit,) = by_name(spans, "fit")
    assert all(s["root"] == fit["id"] for s in spans)
    generations = by_name(spans, "de.generation")
    assert len(generations) == 5
    assert len(by_name(spans, "de.evaluate")) == 6
    assert len(by_name(spans, "de.init")) == 1
    assert len(by_name(spans, "de.result")) == 1
    # G generations (tol 0, every energy finite, no checkpoints): two reads
    # a convergence test, tested G + 2 times, and two copies of the
    # result; on the CPU no copy goes to a card.
    g = 5
    syncs = tracing.counters()["syncs"]
    assert syncs == {"de.converged.finite": g + 2,
                     "de.converged.spread": g + 2,
                     "de.result.population": 1, "de.result.energies": 1}
    assert len(by_name(spans, "sync")) == 2 * g + 6
    # Each generation but the chunk's last holds the test that follows it.
    inside = [sum(s["name"] == "sync" and s["parent"] == gen["id"]
                  for s in spans) for gen in generations]
    assert inside == [2, 2, 2, 2, 0]


def test_a_regional_call_on_four_shards_records_each_shard():
    rng = np.random.default_rng(5)
    c, t, n = 4, 60, 8
    prec, etp, qobs = (torch.tensor(rng.uniform(0, hi, (c, t)))
                       for hi in (15, 4, 5))
    qobs[0, :10] = torch.nan
    params = {"x1": torch.tensor(rng.uniform(100, 1200, n)),
              "x2": torch.tensor(rng.uniform(-5, 3, n)),
              "x3": torch.tensor(rng.uniform(20, 300, n)),
              "x4": torch.tensor(rng.uniform(1.1, 2.9, n))}
    mesh = ensemble_catchment_mesh(2, 2, devices=["cpu"] * 4)
    args = (prec, etp, qobs, 0.3, 0.3, params)
    plain = regional_gr4j_objective(*args, mesh=mesh, loss_metric="kge")
    with host_profiler():
        traced = regional_gr4j_objective(*args, mesh=mesh, loss_metric="kge")
    assert torch.equal(traced, plain)

    spans = tracing.spans()
    (root,) = by_name(spans, "regional.objective")
    assert all(s["root"] == root["id"] for s in spans)
    shards = by_name(spans, "mesh.shard")
    assert sorted(s["attrs"]["shard"] for s in shards) == [0, 1, 2, 3]
    assert {s["attrs"]["device"] for s in shards} == {"cpu"}
    assert len(by_name(spans, "mesh.copy")) == 4
    assert len(by_name(spans, "mesh.assemble")) == 1
    kernels = by_name(spans, "ops.gr4j_regional_objective_fused")
    assert len(kernels) == 4
    parents = {k["parent"] for k in kernels}
    assert {s["name"] for s in spans if s["id"] in parents} == {"mesh.shard"}
    (sync,) = by_name(spans, "sync")
    assert sync["attrs"] == {"site": "ops.valid_counts"}
    (counts,) = by_name(spans, "regional.counts")
    assert sync["parent"] == counts["id"]
    assert tracing.counters()["syncs"] == {"ops.valid_counts": 2}


def test_trace_writes_the_spans_it_saw(tmp_path):
    tracing.sync("before", int, torch.tensor(1))
    with tracing.span("before"):
        pass
    with trace(tmp_path / "trace"):
        with tracing.span("inside", device="cpu"):
            tracing.sync("read", bool, torch.tensor(True))
    with open(tmp_path / "trace" / "rrmpg_spans.json") as f:
        out = json.load(f)
    assert out["clock"] == "time.time_ns"
    assert out["counters"] == {"spans_dropped": 0, "launches": {},
                               "syncs": {"read": 1}}
    assert [s["name"] for s in out["spans"]] == ["inside", "sync"]
    assert out["spans"][1]["parent"] == out["spans"][0]["id"]
    assert out["spans"][0]["attrs"] == {"device": "cpu"}
