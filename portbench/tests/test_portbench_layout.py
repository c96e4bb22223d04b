"""BENCHMARK.json against the contract, and every name in it resolving to
its files: a cell, configuration, mix or metric is data and files found
by name."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib import cells

BENCH = json.loads(cells.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (cells.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = cells.resolve(cell)
    cells.load_module("inputs", c.config["scene"]["generator"])
    cells.load_module("steps", c.step_kind)
    judge = cells.load_module("judges", c.step_kind)
    assert set(c.limits) == set(judge.NUMBERS)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert hasattr(cells.load_module("e2e", m["name"]), "read")
    for m in c.per_layer:
        assert hasattr(cells.load_module("metrics", m["name"]), "read")
        # a per-layer metric moves an end-to-end metric its cells report
        assert m["moves"] in e2e


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    names = set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a cell by a new traffic file and a
    new `workloads` entry, and runs it, with no file edited."""
    import shutil
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench" / "traffic" / "extract-b2.json").write_text(
        json.dumps({"step": "extract", "batch": 2, "check": {"items": 1}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tum-fr1-vga.extract-b2",
                               "config": "tum-fr1-vga",
                               "traffic": "extract-b2", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tum-fr1-vga.extract-b256" in m.get("workloads", []):
            m["workloads"].append("tum-fr1-vga.extract-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(cells.HERE / "limits" / "tum-fr1-vga.extract-b256.json",
                root / "portbench" / "limits" / "tum-fr1-vga.extract-b2.json")
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from portbench.lib import harness\n"
        "out = harness.run('tum-fr1-vga.extract-b2', 5, 0, False, 'cpu', "
        "overrides={'config': {'image': {'height': 64, 'width': 80}, "
        "'scene': {'frames': 4}}}, steps=2)\n"
        "assert out.ok, out.checks\n"
        "print(sorted(out.line['metrics']))\n")
    res = subprocess.run([sys.executable, "-c", code, str(root),
                          str(cells.ROOT)], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "kf_per_s" in res.stdout and "batch_ms_p95" in res.stdout
