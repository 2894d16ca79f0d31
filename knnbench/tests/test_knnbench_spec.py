"""BENCHMARK.json: every cell finds its configuration, traffic, traffic
kind and metric files by name, and names, units and keys keep to the
allowed forms."""

import json
import re

import pytest

from knnbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["knnbench"]
    assert BENCH["command"][1] == "knnbench/run.py"
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_file_by_name(cell):
    c = spec.resolve_cell(BENCH, cell)
    assert callable(spec.load_kind(c.traffic["kind"]))
    assert c.chips in (1, 4)
    for key in ("dataset", "n_points", "dim", "k", "backend"):
        assert key in c.config
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_reader(m["name"]))


def test_unknown_cell_and_metric_fail():
    with pytest.raises(KeyError):
        spec.resolve_cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no.such.metric")
    with pytest.raises(FileNotFoundError, match="closed_batches"):
        spec.load_kind("no_such_kind")


def test_every_config_is_used_and_named_in_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("knnbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert spec.NAME_RE.match(key)
            assert not key.endswith(("_dim", "_rank")) and key != "dim"


def test_names_units_and_text():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert spec.NAME_RE.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert TEXT_RE.match(entry[key]), entry[key]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME_RE.match(w["config"])
        assert spec.NAME_RE.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert spec.UNIT_RE.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
