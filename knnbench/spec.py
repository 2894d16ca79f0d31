"""``BENCHMARK.json`` and the files that its names lead to.

A cell names a configuration and a traffic mix; the harness reads
``configs/<config>.json`` and ``traffic/<traffic>.json`` beside this
file.  Every metric, end to end or per layer, is read by
``metrics/<name>.py``, whose ``read(run)`` returns a number or None.  A
later change adds a configuration, a mix or a metric by adding such files
and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = [
    "HERE", "ROOT", "NAME_RE", "UNIT_RE", "Cell", "load_benchmark",
    "resolve_cell", "load_reader", "cell_metrics",
]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple  # metric entries of BENCHMARK.json
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(entries, cell: str) -> tuple:
    """The metric entries that apply to ``cell``: those that list it under
    ``workloads``, and those with no such key."""
    return tuple(m for m in entries
                 if "workloads" not in m or cell in m["workloads"])


def resolve_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration and traffic
    files read; raises ``KeyError`` for an unknown name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _load_json(ROOT / entry["file"])
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {config.get('name')!r}, "
                         f"not {entry['name']!r}")
    traffic = _load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        chips=int(w["chips"]),
        end_to_end=cell_metrics(bench["end_to_end"], name),
        per_layer=cell_metrics(bench["per_layer"], name),
    )


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "knnbench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
