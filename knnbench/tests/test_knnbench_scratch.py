"""A cell is added as files and entries alone.

A scratch benchmark under ``tmp_path``, beside a copy of the real one,
adds one cell: a configuration at k = 50 on a 3-D cloud that a
``datasets/`` file makes, a traffic mix whose kind is a ``kinds/`` file
that hands over to ``closed_batches``, and a reader.  The cell resolves
from the scratch checkout, runs on the CPU through ``drivers.run_cell``
and reads correct, its reader reads, and no file of the real harness
changes."""

import hashlib
import json
import shutil

from knnbench import compare, drivers, spec
from knnbench.run import result_line

CELL = "shells-sor-k50"

DATASET = '''"""shells3d: noisy spherical shells in 3-D with sparse far points,
the kind of cloud an outlier filter cleans."""

import numpy as np


def make(n, seed):
    rng = np.random.default_rng(seed)
    n_far = max(1, n // 100)
    centers = rng.uniform(-5.0, 5.0, size=(8, 3))
    which = rng.integers(0, len(centers), n - n_far)
    v = rng.normal(size=(n - n_far, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    shell = centers[which] + v * (1.0 + rng.normal(0.0, 0.02, (len(v), 1)))
    far = rng.uniform(-20.0, 20.0, size=(n_far, 3))
    return np.concatenate([shell, far]).astype(np.float32)
'''

KIND = '''"""sor_passes: the whole cloud's self query, batch after batch: the
closed loop of ``closed_batches``, found by name and run as it is."""

from knnbench.spec import load_kind


def run(rec, cell, *args):
    load_kind("closed_batches", cell.home)(rec, cell, *args)
'''

READER = '''"""sor.rows_per_batch: query rows per window batch."""


def read(run):
    if not run.batches:
        return None
    return sum(b["rows"] for b in run.batches) / len(run.batches)
'''

CONFIG = {
    "name": "shells_sor_k50", "dataset": "shells3d", "n_points": 4000,
    "cloud_seed": 3, "dim": 3, "dtype": "float32", "metric": "l2", "k": 50,
    "backend": "trueknn", "backend_cfg": {}, "cpu_test": {"n_points": 4000},
}
TRAFFIC = {
    "kind": "sor_passes", "queries": "self", "warm_passes": 3,
    "check_rows_per_batch": 512, "check_rows_max": 4096, "cpu_test": {},
}


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _scratch_benchmark(root):
    home = root / "knnbench"
    shutil.copytree(spec.HERE, home,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    bench["configs"].append({
        "name": CONFIG["name"], "source": "a scratch deployment",
        "file": "knnbench/configs/shells_sor_k50.json", "reduced": [],
        "why": "k = 50 on a cloud of its own file"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG["name"], "traffic": "sor_passes",
        "chips": 1, "why": "whole-cloud self kNN at k = 50"})
    bench["per_layer"].append({
        "name": "sor.rows_per_batch", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "scratch", "moves": "knn_qps",
        "workloads": [CELL]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (home / "configs" / "shells_sor_k50.json").write_text(json.dumps(CONFIG))
    (home / "traffic" / "sor_passes.json").write_text(json.dumps(TRAFFIC))
    (home / "datasets").mkdir(exist_ok=True)
    (home / "datasets" / "shells3d.py").write_text(DATASET)
    (home / "kinds" / "sor_passes.py").write_text(KIND)
    (home / "metrics" / "sor.rows_per_batch.py").write_text(READER)


def test_a_cell_added_as_files_alone_runs(tmp_path):
    before = _digests(spec.HERE)
    _scratch_benchmark(tmp_path)
    cell = spec.resolve_cell(spec.load_benchmark(tmp_path), CELL,
                             root=tmp_path)
    assert cell.home == tmp_path / "knnbench"
    assert cell.config["k"] == 50 and cell.cpu_test == {"n_points": 4000}
    rec = drivers.run_cell(cell, 2**31 + 11, 0.5, False, device="cpu",
                           sizes=cell.cpu_test)
    assert compare.judge(rec.checks), rec.checks
    assert rec.k == 50 and rec.rows_checked > 0
    assert rec.batches and rec.batches[0]["rows"] == 4000
    e2e = result_line(rec, cell, False, "cpu")
    assert e2e["correct"]
    assert {"knn_qps", "setup_s"} <= set(e2e["metrics"])
    layer = result_line(rec, cell, True, "cpu")["metrics"]
    assert layer == {"sor.rows_per_batch": {"value": 4000.0, "unit": "rows"}}
    # the program's counters are there for any reader of the new cell
    assert spec.load_reader("search.rounds_launched", cell.home)(rec) >= 1
    assert spec.load_reader("grid.probe_passes", cell.home)(rec) > 0
    assert _digests(spec.HERE) == before
    assert not (spec.HERE / "datasets" / "shells3d.py").exists()
