"""What the benchmark loads: never JAX, its relatives or the JAX package,
and a reference that takes nothing from the program."""

import ast
import json
import subprocess
import sys
import types

import pytest

from perfbench.tests.conftest import ROOT

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "rrmpg_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from perfbench.harness import forbidden_modules

    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "rrmpg_tpu_torch.fake",
                        types.ModuleType("fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("fake"))
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "rrmpg_tpu.fake",
                        types.ModuleType("fake"))
    assert set(forbidden_modules()) == before | {"rrmpg_tpu"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"rrmpg_tpu_torch"})


def test_no_source_reads_the_jax_harness():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "benchmarks/" not in text, path


def run_python(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_nothing_of_the_program():
    proc = run_python(
        "import sys; sys.path.insert(0, '.')\n"
        "import perfbench.reference.gr4j, perfbench.reference.snow, "
        "perfbench.reference.losses\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'rrmpg_tpu_torch', 'rrmpg_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_a_whole_run_loads_no_forbidden_module():
    """A cell run end to end on the CPU, at a small size, in a process of
    its own: after it ``sys.modules`` holds none of the four names."""
    proc = run_python(
        "import sys, json; sys.path.insert(0, '.')\n"
        "import torch\n"
        "from perfbench.harness import resolve, execute, "
        "forbidden_modules\n"
        "from perfbench.tests.conftest import SMALL\n"
        "plan = resolve('gr4j.mc-decade')\n"
        "plan.traffic.update(SMALL['gr4j.mc-decade'])\n"
        "res = execute(plan, [torch.device('cpu')], 3, 0.1)\n"
        "print(json.dumps(forbidden_modules()))")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
