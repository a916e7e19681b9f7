"""``BENCHMARK.json`` against the benchmark's contract, and the shape of a
run's result: the keys of the last line, no result without a card, and
nothing found by name missing."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import spec
from port_bench.run import main
from port_bench.tests.conftest import BORN, BRICK, toy_run

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["port_bench"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (spec.PKG / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert (spec.PKG / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_the_contract_asks(workload):
    cell = spec.load_cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    assert spec.load_driver(cell.config["driver"]).Driver
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]))


@pytest.mark.parametrize("workload", [BRICK, BORN])
def test_result_line_has_the_contract_keys(workload):
    result = toy_run(workload)
    assert list(result) == RESULT_KEYS
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    json.loads(json.dumps(result, allow_nan=False))


def test_no_card_no_result(capsys, monkeypatch):
    """Where torch sees no card, the run exits non-zero and prints no result
    (the card is hidden, so this holds on a machine that has one too)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_bare_directory_fails(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the harness has
    no program to run: no result, a non-zero exit."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_paths_hold_only_the_benchmark():
    root = Path(BENCH["paths"][0])
    assert not root.name.endswith("_torch") and (ROOT / root).is_dir()
