"""The harness: finds a cell's files by name, runs its set-up, window and
check, reads its metrics and builds the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the path in ``BENCHMARK.json``): the model,
  its family, dtype, bounds and forcing; ``models/<family>.py`` makes its
  inputs, calls the program and hands the same inputs to the reference in
  ``reference/``;
* ``traffic/<traffic>.json``: the mix's parameters and its ``kind``, the
  loop in ``loops/<kind>.py`` that drives it;
* ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` -> a number,
  or None where the run has nothing to read.

A new cell, configuration, mix or metric is new files and an entry in
``BENCHMARK.json``; no file that is there needs an edit.
"""

import dataclasses
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rrmpg_tpu")


@dataclasses.dataclass
class Plan:
    """One cell as ``BENCHMARK.json`` and its files define it."""
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict

    @property
    def model(self):
        return importlib.import_module(
            f"perfbench.models.{self.config['family']}")

    @property
    def loop(self):
        return importlib.import_module(
            f"perfbench.loops.{self.traffic['kind']}")


@dataclasses.dataclass
class Window:
    """What a measured window did: its host-clock length (from its start to
    the synchronise that ends its last call), its bounds on the clock the
    profiler's events use (``time.time_ns``), the work completed (member
    days, over every catchment), the entry calls, and the benchmark's own
    host spans ``(name, start_ns, end_ns)``."""
    seconds: float
    open_ns: int
    close_ns: int
    work: float
    calls: int
    spans: list


def _metric_applies(metric, name, cell_e2e):
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves") in cell_e2e


def _load_reader(root, name):
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(name, root=ROOT):
    """The :class:`Plan` of workload ``name`` in the benchmark at ``root``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(workloads)}")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"])
                        .read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{workload['traffic']}.json").read_text())
    cell = json.loads((root / "perfbench" / "cells" / f"{name}.json")
                      .read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _metric_applies(m, name, e2e_names)]
    readers = {m["name"]: _load_reader(root, m["name"])
               for m in e2e + per_layer}
    return Plan(workload, config, traffic, cell["limits"], e2e, per_layer,
                readers)


def torch_seed(seed):
    """``--seed`` as a non-negative seed for ``torch`` and ``numpy``."""
    return int(seed) % (2 ** 63)


def stratified(n, parts, generator):
    """One index of ``range(n)`` in each of ``parts`` equal slices of it,
    drawn from ``generator``: a (parts,) tensor on its device."""
    import torch

    edges = [j * n // parts for j in range(parts + 1)]
    draws = torch.rand(parts, generator=generator,
                       device=generator.device).tolist()
    return torch.tensor([lo + min(int(d * (hi - lo)), hi - lo - 1)
                         for d, lo, hi in zip(draws, edges, edges[1:])],
                        device=generator.device)


def synchronize(devices):
    import torch

    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def prepare(run, devices):
    """The cell's set-up, then one call of every shape the window uses,
    synchronised; returns the seconds of that warm-up call."""
    run.setup()
    synchronize(devices)
    start = time.perf_counter()
    run.finish([run.call([])])
    synchronize(devices)
    return time.perf_counter() - start


def window(run, seconds, devices):
    """``run.call`` back to back until ``seconds`` have passed on the host
    clock, then one synchronise: the :class:`Window`, its work as
    ``run.finish`` counts it from the calls' outputs."""
    spans, outputs = [], []
    synchronize(devices)
    open_ns, start = time.time_ns(), time.perf_counter()
    while time.perf_counter() - start < seconds:
        outputs.append(run.call(spans))
    synchronize(devices)
    elapsed, close_ns = time.perf_counter() - start, time.time_ns()
    return Window(elapsed, open_ns, close_ns, run.finish(outputs),
                  len(outputs), spans)


def card_limits():
    """The cards' names and power limits as ``nvidia-smi`` reads them (a
    card set below its 700 W runs slower under load), or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return proc.stdout.strip().replace("\n", "; ") or None


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""
    plan: Plan
    run: object
    window: Window
    setup_s: float
    chips: int
    trace: object = None


def gaps(answers, reference):
    """{'<answer>_gap': widest gap} of the program's answers against the
    reference's."""
    from perfbench.reference.losses import widest_gap

    return {f"{k}_gap": widest_gap(answers[k], reference[k])
            for k in answers}


def execute(plan, devices, seed, seconds, trace=False, started=None,
            out=sys.stderr):
    """Run one cell on ``devices``: set-up, the window, the check.  Returns
    the result line as a dict, or None where a forbidden module was
    loaded."""
    import torch

    started = time.perf_counter() if started is None else started
    entered = time.perf_counter()
    run = plan.loop.Run(plan, devices, torch_seed(seed))
    warmup_s = prepare(run, devices)
    setup_s = time.perf_counter() - started
    print(f"setup {setup_s:.3f} s: {entered - started:.3f} s to the "
          f"harness (imports), {setup_s - entered + started:.3f} s in the "
          f"cell's set-up (cards, inputs, kernel library), of it "
          f"{warmup_s:.3f} s the warm-up call", file=out)

    tracer = None
    if trace:
        from perfbench.trace import Tracer
        tracer = Tracer(devices)
        with tracer:
            measured = window(run, seconds, devices)
        tracer.read(measured)
    else:
        measured = window(run, seconds, devices)
    cards = [d for d in devices if d.type == "cuda"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    run.release()

    answers = run.answers()
    reference = run.reference(torch.float64)
    numbers = gaps(answers, reference)
    if hasattr(run, "scores"):
        numbers.update(run.scores())
    checks = {k: {"value": v, "limit": plan.limits.get(k)}
              for k, v in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    ctx = Context(plan, run, measured, setup_s, len(devices), tracer)
    wanted = plan.per_layer if trace else plan.end_to_end
    metrics = {}
    for m in wanted:
        value = plan.readers[m["name"]](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cards:
        print(f"cards: {card_limits()}", file=out)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=out)
        return None
    device = {"platform": "gpu" if cards else devices[0].type,
              "kind": (torch.cuda.get_device_name(cards[0]) if cards
                       else devices[0].type),
              "count": len(devices), "memory_peak_bytes": peak}
    # Every entry call of the window is attempted; one that raised would
    # have ended the run, so none failed.
    result = {"correct": correct, "attempted": measured.calls, "failed": 0,
              "metrics": metrics, "device": device}
    if tracer is not None:
        device["busy_s"] = tracer.busy_mean_s()
        device["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=out)
    return result
