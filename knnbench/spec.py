"""``BENCHMARK.json`` and the files that its names lead to.

A cell names a configuration and a traffic mix; the harness reads
``configs/<config>.json`` and ``traffic/<traffic>.json`` beside this
file.  The traffic file's ``kind`` names its driver,
``kinds/<kind>.py``, whose ``run(...)`` drives one run; a configuration's
``dataset`` names a frozen generator of ``datagen.py`` or a cloud file
``datasets/<dataset>.py``, whose ``make(n, seed)`` makes the points.
Every metric, end to end or per layer, is read by ``metrics/<name>.py``,
whose ``read(run)`` returns a number or None.  The sizes at which the
CPU tests run a cell are the ``cpu_test`` groups of its configuration and
traffic files.  A later change adds a configuration, a traffic mix or
kind, a cloud or a metric by adding such files and entries; nothing here
names one.  Every lookup takes the harness directory it searches
(``home``, by default this one), so a benchmark beside this one resolves
its own files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = [
    "HERE", "ROOT", "NAME_RE", "UNIT_RE", "Cell", "load_benchmark",
    "resolve_cell", "load_module", "load_reader", "load_kind",
    "cell_metrics",
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
    #: the sizes of a CPU test run: the traffic's ``cpu_test`` group,
    #: overridden by the configuration's
    cpu_test: dict
    #: the harness directory whose files the cell was resolved from
    home: Path


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


def resolve_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration and traffic
    files read, from the checkout at ``root`` (the directory that holds
    ``bench``'s ``BENCHMARK.json``); raises ``KeyError`` for an unknown
    name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    home = root / HERE.relative_to(ROOT)
    config = _load_json(root / entry["file"])
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {config.get('name')!r}, "
                         f"not {entry['name']!r}")
    traffic = _load_json(home / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        chips=int(w["chips"]),
        end_to_end=cell_metrics(bench["end_to_end"], name),
        per_layer=cell_metrics(bench["per_layer"], name),
        cpu_test={**traffic.get("cpu_test", {}),
                  **config.get("cpu_test", {})},
        home=home,
    )


def load_module(home: Path, group: str, name: str):
    """The module of ``<home>/<group>/<name>.py``, loaded from its file;
    raises ``FileNotFoundError``, naming the files there, if it is
    missing."""
    path = home / group / f"{name}.py"
    if not path.is_file():
        found = sorted(p.stem for p in (home / group).glob("*.py"))
        raise FileNotFoundError(f"no {group} file for {name!r} at {path}; "
                                f"found: {found}")
    mod_name = f"knnbench_{group}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, home: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(home, "metrics", metric).read


def load_kind(kind: str, home: Path = HERE):
    """The ``run`` function of ``kinds/<kind>.py``: the driver of a traffic
    file's ``kind``."""
    return load_module(home, "kinds", kind).run
