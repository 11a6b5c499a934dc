"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic; the harness then reads
``hvdbench/configs/<config>.json``, ``hvdbench/traffic/<traffic>.json``,
``hvdbench/limits/<cell>.json`` and the family driver
``hvdbench/families/<family>.py`` that the configuration names, and runs
each per-layer metric of ``BENCHMARK.json`` through its reader
``hvdbench/metrics/<metric>.py``.  A new cell, configuration or metric is
new files and a new entry, never an edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def family(self):
        return importlib.import_module(
            f"hvdbench.families.{self.config['family']}")


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(path: Path) -> Dict:
    return json.loads(path.read_text())


def load(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = Cell(
        name=name, chips=entry["chips"],
        config=_read(HERE / "configs" / f"{entry['config']}.json"),
        traffic=_read(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_read(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in(m, name)])
    return cell


def _in(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of ``hvdbench/metrics/<name>.py``: the metric's value,
    or None where the capture holds nothing for it to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hvdbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def seed_for(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's ``--seed`` and what it is
    for: the same seed gives the same inputs, whatever its size."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1

