"""What a run measures, read from data: ``BENCHMARK.json`` at the checkout's
root names the cell; the cell names a configuration file
(``benchmark/configs/<config>.json``) and a traffic file
(``benchmark/traffic/<traffic>.json``, whose ``kind`` picks the driver in
``benchmark/modes/<kind>.py``); the limits of its correctness check are in
``benchmark/limits/<cell>.json``; each per-layer metric is a reader in
``benchmark/metrics/<metric>.py``. Nothing here lists names: a cell, a
configuration, a mix or a metric is added as files and an entry of
``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]          # the configuration file
    traffic: Dict[str, Any]         # the traffic file
    limits: Dict[str, float]        # the correctness limits
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports, trace 0
    per_layer: List[Dict[str, Any]]   # and with trace 1
    root: Path                      # the checkout's root
    bench_dir: Path


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = read_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = entries[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    # a per-layer metric without "workloads" is reported wherever the
    # end-to-end metric it moves is
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    limits_path = bench_dir / "limits" / f"{name}.json"
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(limits_path) if limits_path.exists() else {},
        end_to_end=e2e, per_layer=per_layer, root=root, bench_dir=bench_dir)


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file loaded by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_module(cell: Cell) -> ModuleType:
    """The driver of the cell's traffic kind: ``modes/<kind>.py``."""
    kind = cell.traffic["kind"]
    path = cell.bench_dir / "modes" / f"{kind}.py"
    if not path.exists():
        raise KeyError(f"traffic kind {kind!r} has no driver {path}")
    return load_module(path, f"_bench_mode_{kind}")


def metric_reader(cell: Cell, metric: str) -> Optional[ModuleType]:
    """The reader of a per-layer metric: ``metrics/<metric>.py``."""
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        return None
    return load_module(path, "_bench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))
