"""``BENCHMARK.json`` and the files its names lead to.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its configuration,
traffic, chips, why and the limits of its comparison); a configuration
``<config>`` is ``configs/<config>.json``; a traffic mix ``<traffic>``
is ``traffic/<traffic>.json``, whose ``kind`` names the driver module
``traffic/<kind>.py``; a per-layer metric ``<metric>`` is the reader
``metrics/<metric>.py``.  Nothing here names a cell, a configuration or
a metric: a later cell adds files and manifest entries only.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict           # the manifest's workloads entry
    spec: Dict            # workloads/<cell>.json
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json

    @property
    def arch(self) -> Dict:
        return self.config["arch"]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec.get("limits") or {}


def load_cell(manifest: Dict, name: str, bench: Path = BENCH) -> Cell:
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r}: {len(entries)} entries in "
                       f"BENCHMARK.json")
    entry = entries[0]
    spec = read_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec.get(key) != entry[key]:
            raise ValueError(f"workload {name!r}: {key} is {spec.get(key)!r} "
                             f"in its file, {entry[key]!r} in the manifest")
    config = read_json(bench / "configs" / f"{entry['config']}.json")
    traffic = read_json(bench / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, spec, config, traffic)


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.traffic.{kind}")


def reader(metric: str, bench: Path = BENCH) -> ModuleType:
    """``metrics/<metric>.py`` (names may hold dots, so by path)."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, cell: str) -> bool:
    listed: Optional[List[str]] = metric.get("workloads")
    return listed is None or cell in listed


def cell_metrics(manifest: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    metrics (``trace`` true), as the manifest lists them."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if _applies(m, cell)]
