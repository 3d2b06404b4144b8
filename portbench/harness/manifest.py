"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives for it; the traffic
mix is ``traffic/<traffic>.json``, whose ``entry`` names
``entries/<entry>.py``; the limits are ``limits/<config>.<entry>.json``;
each metric's reader is ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells of the metric's
    ``workloads`` list; an end-to-end metric without the list, every cell."""
    return cell in metric.get("workloads", [cell])


def merge(base: Dict[str, Any], changes: Dict[str, Any]) -> None:
    """Put ``changes`` into ``base``, a section that is a dict in both key
    by key."""
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            base[key].update(value)
        else:
            base[key] = value


def load_cell(name: str, root: Path = ROOT, override: Optional[Dict[str, Dict]] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``.  ``override``
    ({"config": {...}, "traffic": {...}}) is merged into the configuration
    and the traffic mix (the CPU tests run a cell at a tiny size this
    way)."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    override = override or {}
    merge(config, override.get("config", {}))
    merge(traffic, override.get("traffic", {}))
    limits = load_json(PKG / "limits" / f"{w['config']}.{traffic['entry']}.json")["limits"]
    unlisted = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unlisted:
        raise ValueError(f"per-layer metrics without a workloads list: {unlisted}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def load_file_module(path: Path, name: str) -> ModuleType:
    """The module in ``path`` (a metric's file name holds dots, so it is
    loaded by location, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    module = load_file_module(path, "portbench_metric_" + re.sub(r"\W", "_", metric))
    return module.read


def entry(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.entries.{name}")


def reference(family: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{family}")
