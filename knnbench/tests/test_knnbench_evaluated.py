"""The reader of the distances the kernels computed,
``search.evaluated_per_query``, and its counter in a whole CPU run."""

import pytest

from knnbench import drivers, spec

BENCH = spec.load_benchmark()


def _record(batches):
    rec = drivers.RunRecord(cell="c", seed=1, seconds=1.0, device="cpu",
                            n_points=100, dim=3, k=8)
    rec.batches = [{"rows": rows, "rounds": [], "n_tests": 0,
                    "start_radius": 0.1, "timings": dict(t)}
                   for rows, t in batches]
    return rec


@pytest.mark.parametrize("batches, want", [
    ([(10, {"d2_evaluated": 1000}), (30, {"d2_evaluated": 3000})], 100.0),
    ([(4, {"d2_evaluated": 6})], 1.5),
    ([], None),
    ([(10, {"grid_builds": 0})], None),
    ([(10, {"d2_evaluated": 5}), (10, {"grid_builds": 0})], None),
    ([(0, {"d2_evaluated": 0})], None),
], ids=["mean over rows", "one batch", "no batch", "no key",
        "one batch without", "no rows"])
def test_evaluated_per_query_reads_the_window(batches, want):
    read = spec.load_reader("search.evaluated_per_query")
    assert read(_record(batches)) == want


def test_evaluated_per_query_is_in_every_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    m = per_layer["search.evaluated_per_query"]
    assert set(m["workloads"]) == cells
    assert m["moves"] == "knn_qps" and m["layer"] == "kernel grid_round"


def test_a_cpu_run_counts_the_distances():
    """A whole CPU run of a cell: every window batch carries the counter,
    and it is at least the rows' tests wherever no round walked."""
    cell = spec.resolve_cell(BENCH, "porto-selfknn")
    rec = drivers.run_cell(cell, 2**33 + 7, 0.3, False, device="cpu",
                           sizes=cell.cpu_test)
    assert rec.batches
    for b in rec.batches:
        t = b["timings"]
        assert t["d2_evaluated"] > 0
        if t["subgrid_rounds"] == 0:
            assert t["d2_evaluated"] == b["n_tests"]
    assert spec.load_reader("search.evaluated_per_query")(rec) > 0
