"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name (bench360/lib/harness.py)."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench360.lib import harness  # noqa: E402

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench360"] and SPEC["command"] == ["python3", "bench360/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])


def test_per_layer_cells_report_what_it_moves():
    bench = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(cell)}, (m["name"], cell)


def test_configurations_and_cells_are_found_by_name():
    bench = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
    for c in SPEC["configs"]:
        cfg = bench.config(c["name"])
        assert os.path.join(ROOT, c["file"]) == os.path.join(bench.dir, "configs", c["name"] + ".json")
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg)
    used = set()
    for w in SPEC["workloads"]:
        wl = bench.workload(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}" and "limits" in wl
        assert hasattr(bench.driver(wl["driver"]), "Driver")
        used.add(w["config"])
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert callable(bench.metric(m["name"]).read)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|rgbd360_tpu)\b", re.M)
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "bench360")):
        for f in files:
            if f.endswith(".py"):
                assert not pattern.search(open(os.path.join(dirpath, f)).read()), f


def test_the_reference_imports_nothing_of_the_program():
    pattern = re.compile(r"^\s*(import|from)\s+rgbd360", re.M)
    ref = os.path.join(ROOT, "bench360", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert not pattern.search(open(os.path.join(ref, f)).read()), f
