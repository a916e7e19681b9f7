"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` is a JSON object whose ``driver`` key names a
module of ``port_bench/drivers/``; the traffic mix is
``port_bench/traffic/<traffic>.json``; a per-layer metric is read by
``port_bench/metrics/<metric name>.py``.  Adding a cell, a configuration or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

__all__ = ["Cell", "load_cell", "load_driver", "load_reader", "PKG", "ROOT"]


@dataclass
class Cell:
    """One workload with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the cell's end-to-end metrics, setup_s included
    per_layer: List[dict]  # the cell's per-layer metrics


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT, traffic_dir: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; ``KeyError`` if it
    has none of that name."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    tdir = Path(traffic_dir) if traffic_dir is not None else PKG / "traffic"
    traffic = json.loads((tdir / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def load_driver(name: str):
    """The module ``port_bench.drivers.<name>``; it defines ``Driver``."""
    return importlib.import_module(f"port_bench.drivers.{name}")


def load_reader(metric: str):
    """``read(ctx)`` of ``port_bench/metrics/<metric>.py`` (a metric's name
    may hold dots, so the file is loaded by path)."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
