"""The readers of the program's own spans on made-up spans and device
events: each gives its hand-computed value, None without a trace or
without a program span, and 0.0 where spans exist but none of its kind."""

import sys

import pytest

from perfbench.harness import Context, Window, _load_reader
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_bench_trace import MS, fake_trace

READERS = ("syncs_per_call.eval", "syncs_per_call.fit", "idle_in_syncs.eval",
           "idle_in_syncs.fit", "de_host_us_per_gen", "shard_start_lag_ms")
K5 = "void gr4j_regional_kernel<float, 3, 7, true, true>(...)"


def sp(id_, name, start_ms, end_ms, parent=None, root=None, **attrs):
    return {"name": name, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "id": id_, "parent": parent,
            "root": id_ if root is None else root, "attrs": attrs}


# Two fits in a 100 ms window, and one sync after it.
FITS = [
    sp(1, "fit", 0, 50),
    sp(2, "de.generation", 10, 30, 1, 1),
    sp(3, "de.evaluate", 11, 20, 2, 1),
    sp(4, "sync", 22, 26, 2, 1, site="de.converged.finite"),
    sp(5, "sync", 28, 29, 2, 1, site="de.converged.spread"),
    sp(6, "de.generation", 30, 40, 1, 1),
    sp(7, "sync", 45, 48, 1, 1, site="de.result.population"),
    sp(8, "fit", 50, 100),
    sp(9, "sync", 60, 70, 8, 8, site="model.to_device"),
    sp(10, "sync", 150, 160, site="de.bounds"),
]


def regional_spans():
    """Two mesh calls of four shards, one a card."""
    out, id_ = [], 100
    for t0 in (0, 50):
        root = id_
        out.append(sp(root, "regional.objective", t0, t0 + 45))
        for shard in range(4):
            out.append(sp(id_ + 1 + shard, "mesh.shard", t0 + shard,
                          t0 + shard + 0.5, root, root,
                          device=f"cuda:{shard}", shard=shard))
        id_ += 10
    return out


def k5_events(starts_ms):
    """Per card, K5 launches at ``starts_ms[card]`` (one a call) and a copy
    that is not K5."""
    return {i: [(K5, int(s * MS), int(s * MS) + 30 * MS) for s in starts]
            + [("Memcpy PtoP", 0, MS)]
            for i, starts in enumerate(starts_ms)}


def context(trace, calls=2):
    from perfbench.harness import resolve

    plan = resolve("gr4j.fit-camels", ROOT)
    return Context(plan, None, Window(0.1, 0, 100 * MS, 1.0, calls, []),
                   1.0, len(trace.indices) if trace else 1, trace)


@pytest.fixture
def program_spans(monkeypatch):
    """Makes ``tracing.spans()`` return the given spans."""
    from rrmpg_tpu_torch.utils import tracing

    def use(spans):
        monkeypatch.setattr(tracing, "spans", lambda: list(spans))

    return use


def read(name, ctx):
    return _load_reader(ROOT, name)(ctx)


def test_syncs_per_call_counts_the_window_s_syncs(program_spans):
    program_spans(FITS)
    ctx = context(fake_trace({0: []}, []))
    # Four syncs in the window (the fifth lies after it), two calls.
    assert read("syncs_per_call.fit", ctx) == 2.0
    assert read("syncs_per_call.eval", ctx) == 2.0


def test_de_host_us_per_gen_leaves_the_syncs_out(program_spans):
    program_spans(FITS)
    ctx = context(fake_trace({0: []}, []))
    # (20 - 4 - 1) ms and 10 ms.
    assert read("de_host_us_per_gen", ctx) == pytest.approx(12500.0)


def test_idle_in_syncs_is_the_idle_time_inside_syncs(program_spans):
    program_spans(FITS)
    busy = [("k", 0, 23 * MS), ("k", 27 * MS, 65 * MS),
            ("k", 80 * MS, 100 * MS)]
    ctx = context(fake_trace({0: busy, 1: [("k", 0, 100 * MS)]}, []))
    # Card 0 idles 23-27 and 65-80; the syncs cover 23-26 and 65-70: 8 of
    # 100 ms.  Card 1 never idles.
    assert read("idle_in_syncs.eval", ctx) == pytest.approx(0.04)
    ctx = context(fake_trace({0: busy}, []))
    assert read("idle_in_syncs.fit", ctx) == pytest.approx(0.08)


def test_shard_start_lag_pairs_shards_with_their_launches(program_spans):
    program_spans(regional_spans())
    starts = [(1, 50), (5, 51), (9, 52), (13, 53)]
    ctx = context(fake_trace(k5_events(starts), []))
    # Call 1: 13 - 1 ms; call 2: 53 - 50 ms.
    assert read("shard_start_lag_ms", ctx) == pytest.approx(7.5)
    starts[2] = (9,)
    ctx = context(fake_trace(k5_events(starts), []))
    assert read("shard_start_lag_ms", ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace_or_a_program_span(name, program_spans,
                                                  monkeypatch):
    program_spans(FITS + regional_spans())
    assert read(name, context(None)) is None
    program_spans([sp(10, "sync", 150, 160)])
    assert read(name, context(fake_trace({0: []}, []))) is None
    # A program without the tracing module (the parent of the change that
    # adds it) reads None, and does not raise.
    import rrmpg_tpu_torch.utils as utils

    program_spans(FITS + regional_spans())
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "rrmpg_tpu_torch.utils.tracing", None)
    assert read(name, context(fake_trace({0: []}, []))) is None


@pytest.mark.parametrize("name", READERS)
def test_zero_where_spans_exist_but_none_of_its_kind(name, program_spans):
    program_spans([sp(1, "ops.losses_from_stats", 10, 20)])
    trace = fake_trace(k5_events([(1,)] * 4), [])
    assert read(name, context(trace)) == 0.0
