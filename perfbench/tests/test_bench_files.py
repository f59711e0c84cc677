"""BENCHMARK.json and the files it names: they parse, they keep to the
file's format, and a cell added as files and an entry is found with no
other edit."""

import importlib
import json
import re
import shutil

import pytest

from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]


def test_entries_have_their_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len(METRICS) == len(set(METRICS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(WORKLOADS) // 4)


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_resolves_to_files_that_exist(name):
    from perfbench.harness import resolve

    plan = resolve(name, ROOT)
    assert plan.config["name"] == plan.workload["config"]
    assert plan.model.__name__.endswith(plan.config["family"])
    assert hasattr(plan.loop, "Run")
    assert plan.limits and set(plan.readers) == {
        m["name"] for m in plan.end_to_end + plan.per_layer}
    e2e = {m["name"] for m in plan.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and plan.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    from perfbench.harness import _load_reader

    assert callable(_load_reader(ROOT, name))


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").glob(
    "*/*.json")), ids=lambda p: p.name)
def test_every_data_file_parses(path):
    data = json.loads(path.read_text())
    if path.parent.name == "traffic":
        importlib.import_module(f"perfbench.loops.{data['kind']}")
    if path.parent.name == "configs":
        importlib.import_module(f"perfbench.models.{data['family']}")


def test_a_cell_added_as_files_and_an_entry_is_found(tmp_path):
    """A new traffic mix, its cell's limits and a workload entry, dropped
    into a copy of the benchmark, make a cell that resolves; no file that
    was there is edited."""
    from perfbench.harness import resolve

    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (copy / "perfbench" / "traffic" / "mc-year.json").write_text(json.dumps(
        {"kind": "mc", "members": 65536, "days": 365, "kept_per_call": 4,
         "checked": 256}))
    (copy / "perfbench" / "cells" / "gr4j.mc-year.json").write_text(
        json.dumps({"limits": {"nse_gap": 1e-3, "kge_gap": 1e-3}}))
    bench["workloads"].append(
        {"name": "gr4j.mc-year", "config": "gr4j-01031500",
         "traffic": "mc-year", "chips": 1, "why": "one year"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    plan = resolve("gr4j.mc-year", copy)
    assert plan.traffic["days"] == 365
    assert {m["name"] for m in plan.end_to_end} == {"setup_s"}
    assert plan.limits == {"nse_gap": 1e-3, "kge_gap": 1e-3}
