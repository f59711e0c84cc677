"""PyTorch port, the ten examples of ``examples/torch`` (CPU).

The port's examples are the counterparts of ``examples/01``-``10`` and
keep their stems.  Read with ``ast``, each imports ``rrmpg_tpu_torch``
(every name it takes from there exists) and nothing of ``jax`` or
``rrmpg_tpu``, and never asks ``torch.cuda.is_available()``: the device is
asked for with ``--device`` (default ``cuda``), and without a card
``main([])`` raises ``RuntimeError`` through ``config.resolve_device``
before it prints anything.  Example 06's ops-level trajectories, unbroken
and in five chained segments, are held to JAX's ``run_gr4j_warm`` on the
same numpy inputs at float32 ``rtol=1e-4, atol=1e-5``, and the chained run
to the unbroken one within 1e-6.

Marked slow, as ``tests/test_examples.py`` is: every port example runs in a
subprocess with ``--device cpu`` at ``RRMPG_EXAMPLE_FAST=1`` and must exit
0 and print (about 4 minutes for the ten, one after the other).
"""

import ast
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO_ROOT / "examples" / "torch").glob("[0-9]*.py"))
JAX_EXAMPLES = sorted((REPO_ROOT / "examples").glob("[0-9]*.py"))
FORBIDDEN = ("jax", "jaxlib", "rrmpg_tpu")


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _imported_modules(tree):
    """(module, names) of every import statement of ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, ()
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", tuple(a.name for a in node.names)


def _load(path):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_torch_examples_discovered():
    assert len(EXAMPLES) == 10, [p.name for p in EXAMPLES]
    assert [p.stem for p in EXAMPLES] == [p.stem for p in JAX_EXAMPLES]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_imports_no_jax(path):
    modules = [m for m, _ in _imported_modules(_tree(path))]
    for module in modules:
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {module}"
    assert any(m.split(".")[0] == "rrmpg_tpu_torch" for m in modules)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_names_resolve(path):
    for module, names in _imported_modules(_tree(path)):
        if module.split(".")[0] != "rrmpg_tpu_torch":
            continue
        imported = importlib.import_module(module)
        for name in names:
            assert hasattr(imported, name) or importlib.util.find_spec(
                f"{module}.{name}") is not None, (
                f"{path.name}: {module} has no {name}")


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_never_asks_for_cuda(path):
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Attribute) and node.attr == "is_available":
            raise AssertionError(
                f"{path.name}:{node.lineno} branches on is_available()")


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_without_card_raises(path, monkeypatch, capsys):
    """The default device is the card: where there is none, ``main([])``
    raises before any study runs (nothing printed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = _load(path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])
    assert capsys.readouterr().out == ""


def test_torch_example_06_matches_jax_run_gr4j_warm():
    import jax.numpy as jnp

    from rrmpg_tpu.ops import gr4j_initial_state, run_gr4j_warm

    torch.set_num_threads(1)
    out = _load(REPO_ROOT / "examples" / "torch" /
                "06_forecast_mode.py").main(["--device", "cpu"])

    # JAX's example on the same numpy inputs.
    rng = np.random.default_rng(1)
    T = 1000
    prec = jnp.asarray(rng.uniform(0, 15, T), jnp.float32)
    etp = jnp.asarray(rng.uniform(0, 4, T), jnp.float32)
    params = {'x1': 320.0, 'x2': 1.1, 'x3': 90.0, 'x4': 2.3}
    state0 = gr4j_initial_state(0.4, 0.6, params, num_uh2=7,
                                dtype=jnp.float32)
    q_full = run_gr4j_warm(prec, etp, state0, params, num_uh1=3,
                           num_uh2=7)[0]
    qs, state = [], state0
    for lo in range(0, T, 200):
        q, _, _, state = run_gr4j_warm(prec[lo:lo + 200], etp[lo:lo + 200],
                                       state, params, num_uh1=3, num_uh2=7)
        qs.append(np.asarray(q))

    assert out["q_full"].dtype == np.float32
    np.testing.assert_allclose(out["q_full"], np.asarray(q_full),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["q_chained"], np.concatenate(qs),
                               rtol=1e-4, atol=1e-5)
    assert np.abs(out["q_chained"] - out["q_full"]).max() <= 1e-6
    assert out["chained_max_dq"] <= 1e-6


def _example_env():
    env = dict(os.environ)
    env["RRMPG_EXAMPLE_FAST"] = "1"
    env["MPLBACKEND"] = "Agg"
    return env


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_executes_on_cpu(path):
    # The documented launch: exec from the repo root (running
    # ``python examples/torch/foo.py`` would put examples/torch itself on
    # sys.path instead of the repository).
    code = (f"exec(open({str(path)!r}).read(), "
            f"{{'__file__': {str(path)!r}, '__name__': '__main__'}})")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu"], cwd=REPO_ROOT,
        env=_example_env(), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{path.name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}")
    assert proc.stdout.strip(), f"{path.name} printed nothing"
