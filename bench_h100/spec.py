"""What a cell is made of, found by the names BENCHMARK.json gives.

A cell names a configuration (``BENCHMARK.json`` ``configs``: its
``file``) and a traffic mix (``bench_h100/traffic/<traffic>.json``);
its comparison limits are ``bench_h100/limits/<cell>.json``; a per-layer
metric is read by ``bench_h100/metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "load_cell", "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in moved and _reports(m, name)]
    return Cell(name, config, traffic, limits, e2e, layer)


def metric_reader(name: str, here: Path = HERE):
    """The ``read(trace)`` function of a per-layer metric."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
