"""PyTorch port, the profiling helpers (CPU).

``rrmpg_tpu_torch.utils.profiling`` keeps ``rrmpg_tpu.utils.profiling``'s
``BenchResult`` fields and ``benchmark`` signature, and its ``trace`` writes
a ``torch.profiler`` trace file.  As in JAX, ``utils/__init__.py`` does not
import it.
"""

import glob
import json

import pytest
import torch

import rrmpg_tpu.utils.profiling as jax_profiling
import rrmpg_tpu_torch.utils as utils
from rrmpg_tpu_torch.utils.profiling import BenchResult, benchmark, trace


def test_bench_result_fields_match_jax():
    assert BenchResult._fields == jax_profiling.BenchResult._fields
    res = BenchResult(compile_s=1.0, best_s=0.5, mean_s=0.6, repeats=3)
    assert res.throughput(100) == pytest.approx(200.0)


def test_benchmark_counts_and_times_calls():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return torch.cumsum(x * scale, 0)

    x = torch.arange(10000, dtype=torch.float64)
    res = benchmark(fn, x, repeats=4, scale=2.0)
    assert len(calls) == 5                # one first call, then the runs
    assert res.repeats == 4
    assert 0.0 < res.best_s <= res.mean_s
    assert res.compile_s > 0.0
    assert res.throughput(10000) == pytest.approx(10000 / res.best_s)


def test_trace_writes_a_trace_file(tmp_path):
    with trace(tmp_path / "trace"):
        torch.ones(256, 256) @ torch.ones(256, 256)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_not_imported_by_the_utils_package():
    assert not hasattr(utils, "benchmark") and not hasattr(utils, "trace")
