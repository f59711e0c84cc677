"""``run.py`` as the check calls it: a result line only where the cards
and the program are there."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


def run(cwd, *args, timeout=900):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gr4j.mc-decade",
         "--seed", str(2 ** 31 + 3), *args], cwd=cwd, capture_output=True,
        text=True, timeout=timeout)


def bare_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_without_the_cards_no_result(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    proc = run(ROOT, "--seconds", "1", timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = run(ROOT, "--seconds", "2", "--trace", "1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["k2_roofline"]["value"] <= 100
    assert list(result)[-1] == "checks"
    bare = run(bare_checkout(tmp_path), "--seconds", "2")
    assert bare.returncode != 0 and bare.stdout.strip() == ""
