"""The port's tracing on its search path: ``core.spans.span`` under and
outside a profiler, the spans of one fused trueknn query and their
nesting, answers unchanged under the profiler, and the counters beside
them (the sizing probe's passes and seconds, the rounds launched, the
grid-build clock of the fused path)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.api.backends.trueknn as tk
from repro_torch import KnnSpec, build_index, make_dataset
from repro_torch.core import spans
from repro_torch.core.grid import build_grid

torch.set_num_threads(1)

PTS = make_dataset("porto", 1500, seed=5)
QS = make_dataset("porto", 64, seed=6)
SPANS = (
    "repro_torch.query", "repro_torch.trueknn.start_radius",
    "repro_torch.trueknn.schedule", "repro_torch.grid.build",
    "repro_torch.grid.probe", "repro_torch.grid.bin",
    "repro_torch.fused.upload", "repro_torch.fused.round",
    "repro_torch.fused.tail", "repro_torch.fused.fetch",
    "repro_torch.trueknn.finish",
)


def _index(**cfg):
    return build_index(PTS, backend="trueknn", device="cpu", **cfg)


def _program_events(prof):
    return [e for e in prof.events() if e.name.startswith("repro_torch.")]


def test_span_is_a_shared_noop_without_a_profiler():
    off = spans.span("repro_torch.a")
    assert isinstance(off, contextlib.nullcontext)
    assert off is spans.span("repro_torch.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:  # entered with no profiler asked for: nothing recorded
            pass
        on = spans.span("repro_torch.c")
        assert on is not off
        with on:
            pass
    assert [e.name for e in _program_events(prof)] == ["repro_torch.c"]
    assert spans.span("repro_torch.d") is off


def test_fused_query_records_every_span_under_query(monkeypatch):
    scheds = []
    real = tk.build_schedule

    def spy(*a, **kw):
        scheds.append(real(*a, **kw))
        return scheds[-1]

    monkeypatch.setattr(tk, "build_schedule", spy)
    index = _index()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = index.query(QS, KnnSpec(8))
    events = _program_events(prof)
    names = [e.name for e in events]
    assert set(names) == set(SPANS)
    assert names.count("repro_torch.query") == 1
    for e in events:
        if e.name == "repro_torch.query":
            assert e.cpu_parent is None
            continue
        up = e.cpu_parent
        while up is not None and up.name != "repro_torch.query":
            up = up.cpu_parent
        assert up is not None, e.name
    parents = {e.name: e.cpu_parent.name for e in events
               if e.cpu_parent is not None}
    assert parents["repro_torch.grid.probe"] == "repro_torch.grid.build"
    assert parents["repro_torch.grid.bin"] == "repro_torch.grid.build"
    assert parents["repro_torch.grid.build"] == "repro_torch.trueknn.schedule"
    assert names.count("repro_torch.fused.round") == \
        res.timings["rounds_launched"] == len(scheds[0].radii)
    assert names.count("repro_torch.grid.build") == \
        index.stats()["grid_builds"]


def test_answers_are_bitwise_the_same_under_the_profiler():
    plain, traced = _index(), _index()
    for q in (QS, QS[::-1] + 0.001, None):
        want = plain.query(q, KnnSpec(6))
        with profile(activities=[ProfilerActivity.CPU]):
            got = traced.query(q, KnnSpec(6))
        assert np.array_equal(got.dists, want.dists)
        assert np.array_equal(got.idxs, want.idxs)
        assert np.array_equal(got.found, want.found)
        assert got.n_tests == want.n_tests
        assert [(r.radius, r.n_queries, r.n_resolved) for r in got.rounds] \
            == [(r.radius, r.n_queries, r.n_resolved) for r in want.rounds]
    assert traced.stats()["warm_radius"] == plain.stats()["warm_radius"]


@pytest.mark.parametrize("j", [0, 2, 4])
def test_probe_passes_count_the_resolutions_tried(j):
    """A cloud whose first resolution is 2^j cells on its longest axis,
    under a table bound no shape meets, coarsens j times: j + 1 passes.
    The same build again is a memo hit and tries none."""
    pts = np.random.default_rng(j).random((500, 2)).astype(np.float32)
    ext = float((pts.max(0) - pts.min(0)).max())
    memo = {}
    g = build_grid(pts, ext / (2**j + 0.5), max_bucket_elems=1,
                   probe_cache=memo)
    assert g.res == (1, 1)
    assert memo["_passes"] == j + 1 and memo["_misses"] == 1
    assert memo["_seconds"] > 0.0
    seconds = memo["_seconds"]
    build_grid(pts, ext / (2**j + 0.5), max_bucket_elems=1, probe_cache=memo)
    assert memo["_hits"] == 1
    assert memo["_passes"] == j + 1 and memo["_seconds"] == seconds


@pytest.mark.parametrize("fused", [True, False])
def test_probe_counters_in_timings_and_stats(fused):
    index = _index(fused=fused)
    first = index.query(QS, KnnSpec(8))
    s = index.stats()
    assert first.timings["grid_probe_passes"] == s["grid_probe_passes"]
    assert first.timings["grid_probe_passes"] >= s["grid_probe_misses"] > 0
    assert first.timings["grid_probe_seconds"] == \
        pytest.approx(s["grid_probe_seconds"])
    assert 0.0 < s["grid_probe_seconds"] <= first.timings[
        "grid_build_seconds"]
    again = index.query(QS, KnnSpec(8))
    assert again.timings["grid_builds"] == 0
    assert again.timings["grid_probe_passes"] == 0
    assert again.timings["grid_probe_seconds"] == 0.0
    assert index.stats()["grid_probe_passes"] == s["grid_probe_passes"]


def test_rounds_launched_is_the_schedule(monkeypatch):
    scheds = []
    real = tk.build_schedule

    def spy(*a, **kw):
        scheds.append(real(*a, **kw))
        return scheds[-1]

    monkeypatch.setattr(tk, "build_schedule", spy)
    index = _index()
    for q in (QS, QS + 0.002, None):
        res = index.query(q, KnnSpec(8))
        ran = sum(1 for r in res.rounds if np.isfinite(r.radius))
        assert res.timings["rounds_launched"] == len(scheds[-1].radii)
        assert res.timings["rounds_launched"] >= ran


def test_fused_build_clock_counts_builds_only():
    index = _index()
    first = index.query(QS, KnnSpec(8))
    assert first.timings["grid_build_seconds"] > 0.0
    again = index.query(QS, KnnSpec(8))
    assert again.timings["grid_builds"] == 0
    assert again.timings["grid_cache_hits"] > 0
    assert again.timings["grid_build_seconds"] == 0.0
