"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, the configuration's
sizes and code, the traffic mix, the reference and the per-layer metric readers.

Every piece lives in a file of its own, named after the piece:

- ``configs/<config>.json`` (the entry's ``file``) and ``configs/<config>.py``;
- ``traffic/<traffic>.json``, whose ``config`` object, where it has one, overrides
  run-time keys of the configuration for this traffic's cells (``dtype``,
  ``validate_args``, ``limits``);
- ``reference/<config>.py``;
- ``layer_metrics/<metric name>.py``; a metric split by the end-to-end metric it moves
  (``k1_roofline_pct.tokens`` beside ``k1_roofline_pct``) is read by the file of the name
  before its first dot when it has none of its own.

So a later cell, configuration, traffic mix or metric is new files plus new entries in
``BENCHMARK.json``, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """Everything one run of one workload needs, read from the files."""

    name: str
    chips: int
    config_name: str
    config: dict  # the configuration's JSON (sizes, seeding, limits), with the traffic's overrides
    traffic_name: str
    traffic: dict  # the loop shape
    end_to_end: List[dict] = field(default_factory=list)  # entries this cell reports
    per_layer: List[dict] = field(default_factory=list)
    config_module: ModuleType = None
    reference_module: ModuleType = None

    def layer_reader(self, metric_name: str) -> ModuleType:
        path = BENCH_DIR / "layer_metrics" / f"{metric_name}.py"
        if not path.is_file():
            path = BENCH_DIR / "layer_metrics" / f"{metric_name.split('.')[0]}.py"
        return load_module(path)


def load_module(path: Path) -> ModuleType:
    """Import a file of this benchmark by its path (its name may hold dots)."""
    name = "cudabench_piece_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(workload: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell named ``workload``, with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have: {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    with open(root / config_entry["file"]) as fh:
        config = json.load(fh)
    traffic = load_traffic(entry["traffic"])
    config.update(traffic.get("config", {}))
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=config,
        traffic_name=entry["traffic"],
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        config_module=load_module(BENCH_DIR / "configs" / f"{entry['config']}.py"),
        reference_module=load_module(BENCH_DIR / "reference" / f"{entry['config']}.py"),
    )
