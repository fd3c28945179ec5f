"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and the files of one cell beside the code.

- a configuration: `benchmark/configs/<config>.json` (the file
  `BENCHMARK.json` names), the run configuration as the program reads it;
- a traffic mix: `benchmark/traffic/<traffic>.json`, the parameters that
  `benchmark/workloads/<driver>.py` (its `driver` key) reads;
- the limits of the correctness comparison:
  `benchmark/limits/<config>.<driver>.json`;
- a metric: `benchmark/metrics/<metric name>.py`, a reader with
  `read(record) -> float | None`.

A cell is put together from these and its entry alone, so a new cell, mix
or metric is new files and entries, with no edit of a file that exists.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, bench: dict | None = None,
            root: Path = ROOT) -> Cell:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"cells: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{entry['config']}.{traffic['driver']}.json"
    limits = json.loads(limits_path.read_text())
    return Cell(name=cell_name, chips=int(entry["chips"]),
                config_name=entry["config"], config=config,
                traffic_name=entry["traffic"], traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell_name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, cell_name)])


def driver(name: str):
    """The workload driver module `benchmark/workloads/<name>.py`."""
    return importlib.import_module(f"benchmark.workloads.{name}")


def reader(metric_name: str):
    """The `read` function of `benchmark/metrics/<metric_name>.py` (the
    name may hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
