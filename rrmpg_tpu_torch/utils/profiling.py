"""Profiling and benchmarking helpers.

Counterpart of ``rrmpg_tpu/utils/profiling.py``:

* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome / Perfetto trace (``*.pt.trace.json``) into ``log_dir``, with
  the card's activity where a card is present;
* :func:`benchmark` -- the wall time of a callable: the first call on its
  own (where PyTorch builds the kernel library and warms its caches), then
  ``repeats`` runs, each ended once the card has finished its work.

Callers import it by module path
(``from rrmpg_tpu_torch.utils.profiling import benchmark``), as the JAX
package's are.
"""

import contextlib
import os
import time
import typing

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir):
    """Capture a trace of the host and, with CUDA, the card's kernels;
    written to ``log_dir`` when the block ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


class BenchResult(typing.NamedTuple):
    compile_s: float   # first call (library build / caches + run)
    best_s: float      # best steady-state wall time per call
    mean_s: float
    repeats: int

    def throughput(self, items: int) -> float:
        """items / best_s."""
        return items / self.best_s


def _tensors(value):
    """The tensors in a (nested) result or argument list."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def _finish(args, kwargs, out):
    """Wait for the card when a CUDA tensor is among the inputs or the
    outputs: a call's time includes its kernels, not only their launch."""
    if any(t.is_cuda for t in _tensors((args, kwargs, out))):
        torch.cuda.synchronize()


def benchmark(fn, *args, repeats: int = 5, **kwargs) -> BenchResult:
    """Time a callable: one first call, then ``repeats`` runs."""
    t0 = time.perf_counter()
    _finish(args, kwargs, fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _finish(args, kwargs, fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return BenchResult(compile_s, float(np.min(times)),
                       float(np.mean(times)), repeats)
