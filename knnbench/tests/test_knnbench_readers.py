"""The readers of the program's counters, and the record they read: the
warm-up's ``timings`` summed key by key, and each window batch's
``timings`` copied when its call returns."""

import numpy as np
import pytest

from knnbench import drivers, spec

BENCH = spec.load_benchmark()


def _record(batches=(), warmup=None):
    rec = drivers.RunRecord(cell="c", seed=1, seconds=1.0, device="cpu",
                            n_points=100, dim=3, k=8)
    rec.batches = [{"rows": 10, "rounds": [], "n_tests": 0,
                    "start_radius": 0.1, "timings": dict(t)}
                   for t in batches]
    rec.warmup_timings = dict(warmup or {})
    return rec


class _Result:
    def __init__(self, timings):
        self.timings = timings


@pytest.mark.parametrize("counts, want", [
    ([13, 13, 13], 13.0),
    ([18, 17], 17.5),
])
def test_rounds_launched_is_the_window_mean(counts, want):
    read = spec.load_reader("search.rounds_launched")
    rec = _record([{"rounds_launched": c, "grid_builds": 0} for c in counts])
    assert read(rec) == want


@pytest.mark.parametrize("batches", [
    [],
    [{"grid_builds": 0}],
    [{"rounds_launched": 13}, {"grid_builds": 0}],
], ids=["no batch", "no key", "one batch without"])
def test_rounds_launched_is_none_without_the_counter(batches):
    assert spec.load_reader("search.rounds_launched")(_record(batches)) is None


@pytest.mark.parametrize("metric, key", [
    ("grid.probe_s", "grid_probe_seconds"),
    ("grid.probe_passes", "grid_probe_passes"),
])
def test_probe_readers_read_the_warmup_sum(metric, key):
    read = spec.load_reader(metric)
    assert read(_record(warmup={key: 70, "grid_builds": 8})) == 70
    assert read(_record(warmup={"grid_builds": 8})) is None
    assert read(_record()) is None


def test_new_readers_are_in_every_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("search.rounds_launched", "grid.probe_s",
                 "grid.probe_passes"):
        assert set(per_layer[name]["workloads"]) == cells


def test_warmup_timings_are_summed_key_by_key():
    rec = _record()
    calls = [
        {"grid_builds": 3, "grid_probe_passes": 40,
         "grid_probe_seconds": 0.25, "grid_build_seconds": 0.5,
         "plan": "fused/rounds<=13", "start_radius_source": "sampled",
         "warm_start_radius": None, "fused_dispatches": 1},
        {"grid_builds": 1, "grid_probe_passes": 30,
         "grid_probe_seconds": 0.125, "grid_build_seconds": 0.25,
         "plan": "fused/rounds<=12", "warm_start_radius": 0.5,
         "fused_dispatches": 1, "flag": True},
        {"grid_builds": 0, "grid_probe_passes": 0,
         "grid_probe_seconds": 0.0, "grid_build_seconds": 0.0,
         "resolved_radius_p50": np.float64(0.75)},
    ]
    for t in calls:
        drivers._note_warm(rec, _Result(t))
    assert rec.warmup_timings == {
        "grid_builds": 4, "grid_probe_passes": 70,
        "grid_probe_seconds": 0.375, "grid_build_seconds": 0.75,
        "fused_dispatches": 2, "warm_start_radius": 0.5,
        "resolved_radius_p50": 0.75}
    # the two sums kept before stay as they were
    assert rec.warmup_grid_builds == 4
    assert rec.warmup_grid_build_s == 0.75


def test_a_batch_keeps_a_copy_of_its_timings(monkeypatch):
    """A whole CPU run of a cell: each window batch's ``timings`` equal the
    numeric entries of its call's result, in a dict of their own; the
    warm-up's sums are those of the calls before the window; the probe's
    passes of warm-up and window add up to the index's own count."""
    from repro_torch.api.index import NeighborIndex

    calls = []  # (index, result) of every query call, in order
    real = NeighborIndex.query

    def query(self, *a, **kw):
        res = real(self, *a, **kw)
        calls.append((self, res))
        return res

    monkeypatch.setattr(NeighborIndex, "query", query)
    cell = spec.resolve_cell(BENCH, "porto-selfknn")
    rec = drivers.run_cell(cell, 2**33 + 5, 0.3, False, device="cpu",
                           sizes=cell.cpu_test)
    n_warm = len(calls) - len(rec.batches)
    assert n_warm >= 1 and rec.batches
    for b, (_, res) in zip(rec.batches, calls[n_warm:]):
        assert b["timings"] is not res.timings
        assert b["timings"] == drivers._numeric(res.timings)
        assert "rounds_launched" in b["timings"]
        res.timings["rounds_launched"] = -1
        assert b["timings"]["rounds_launched"] >= 1
    want = {}
    for _, res in calls[:n_warm]:
        for key, v in drivers._numeric(res.timings).items():
            want[key] = want.get(key, 0) + v
    assert rec.warmup_timings == want
    index = calls[0][0]
    window = sum(b["timings"]["grid_probe_passes"] for b in rec.batches)
    assert (rec.warmup_timings["grid_probe_passes"] + window
            == index.stats()["grid_probe_passes"])
    assert spec.load_reader("grid.probe_passes")(rec) == \
        rec.warmup_timings["grid_probe_passes"] > 0
