"""The port's index API against the JAX package: brute kNN / hybrid /
range for the four metrics, TrueKNN's native range, plan trees and plan
bookkeeping, the reference's errors, and the device knob.  The generic
routes are held against the reference in ``test_torch_planner.py``."""

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro_torch import (
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
)
from repro_torch.api import get_metric

torch.set_num_threads(1)

METRICS = ["l2", "l1", "linf", "cosine"]
PTS = make_dataset("iono", 400, seed=7)
QS = make_dataset("iono", 30, seed=8)


def _jspec(spec):
    if isinstance(spec, KnnSpec):
        return jax_api.KnnSpec(spec.k, start_radius=spec.start_radius)
    if isinstance(spec, HybridSpec):
        return jax_api.HybridSpec(spec.k, spec.radius)
    return jax_api.RangeSpec(spec.radius, max_neighbors=spec.max_neighbors)


def _radius(metric, pct=50.0):
    dist = get_metric(metric).pairwise(QS, PTS)
    return float(np.percentile(np.sort(dist, 1)[:, 6], pct))


@pytest.mark.parametrize("metric", METRICS)
def test_brute_knn_and_hybrid(metric):
    port = build_index(PTS, backend="brute", device="cpu")
    ref = jax_api.build_index(PTS, backend="brute")
    r = _radius(metric)
    for q, spec in ((QS, KnnSpec(6)), (None, KnnSpec(4)),
                    (QS, HybridSpec(6, r)), (QS, KnnSpec(6, start_radius=r))):
        got = port.query(q, spec, metric=metric)
        want = ref.query(q, _jspec(spec), metric=metric)
        if metric == "cosine":
            # the cosine transform is a float32 normalization on both
            # sides; held to the reference tests' tolerance
            np.testing.assert_allclose(got.dists, want.dists, rtol=1e-4,
                                       atol=1e-6)
        else:
            assert np.array_equal(got.dists, want.dists)
            assert np.array_equal(got.idxs, want.idxs)
            if want.found is not None:
                assert np.array_equal(got.found, want.found)
        assert got.n_tests == want.n_tests
        assert got.metric == metric and got.backend == "brute"


@pytest.mark.parametrize("metric", METRICS)
def test_brute_range_csr(metric):
    """Range through the counted pairwise_topk: same ball populations
    (offsets) and the same neighbor sets; distances on the kernel
    contract (the reference runs its Pallas kernel in interpret mode)."""
    port = build_index(PTS, backend="brute", device="cpu")
    ref = jax_api.build_index(PTS, backend="brute")
    r = _radius(metric, 60.0)
    for q in (QS, None):
        got = port.query(q, RangeSpec(r), metric=metric)
        want = ref.query(q, jax_api.RangeSpec(r), metric=metric)
        assert np.array_equal(got.offsets, want.offsets)
        for i in range(got.n_queries):
            gi, gd = got.neighbors(i)
            wi, wd = want.neighbors(i)
            assert np.array_equal(np.sort(gi), np.sort(wi))
            np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-6)
        assert got.n_tests == want.n_tests
        assert got.timings["plan"] == want.timings["plan"] == "counted_topk"
        assert got.timings["count_rounds"] == want.timings["count_rounds"]
    capped = port.query(QS, RangeSpec(r, max_neighbors=3), metric=metric)
    assert capped.counts.max() <= 3 and capped.truncated.any()


@pytest.mark.parametrize("fused", [True, False])
def test_trueknn_native_range(fused):
    port = build_index(PTS, backend="trueknn", device="cpu", fused=fused)
    ref = jax_api.build_index(PTS, backend="trueknn", fused=fused)
    r = _radius("l2", 80.0)
    for q in (None, QS):
        got = port.query(q, RangeSpec(r))
        want = ref.query(q, jax_api.RangeSpec(r))
        for key in ("offsets", "idxs", "dists"):
            assert np.array_equal(getattr(got, key), getattr(want, key))
        assert got.n_tests == want.n_tests
        for key in ("plan", "grid_builds", "grid_cache_hits", "count_rounds"):
            assert got.timings[key] == want.timings[key], key
    for key in ("rounds", "dispatches", "query_upload_skips", "grid_builds",
                "grid_cache_hits"):
        assert port.stats()[key] == ref.stats()[key], key


@pytest.mark.parametrize("backend", ["brute", "trueknn"])
def test_explain_matches(backend):
    port = build_index(PTS, backend=backend, device="cpu")
    ref = jax_api.build_index(PTS, backend=backend)
    metrics = METRICS if backend == "brute" else ["l2"]
    for metric in metrics:
        for spec in (KnnSpec(5), HybridSpec(5, 0.1), RangeSpec(0.1)):
            got = port.prepare(spec, metric=metric)
            want = ref.prepare(_jspec(spec), metric=metric)
            assert got.explain() == want.explain()


def test_prepared_plan_padding_and_cache_stats():
    port = build_index(PTS, backend="brute", device="cpu")
    ref = jax_api.build_index(PTS, backend="brute")
    plan = port.prepare(KnnSpec(3))
    jplan = ref.prepare(jax_api.KnnSpec(3))
    for m in (5, 7, 5, 16):  # 5 and 7 share the pow2 bucket of 8
        a, b = plan(QS[:m]), jplan(QS[:m])
        assert np.array_equal(a.idxs, b.idxs)
        assert a.timings.get("padded_rows") == b.timings.get("padded_rows")
    assert plan.cache_stats() == jplan.cache_stats()


def test_reference_errors_kept():
    brute = build_index(PTS, backend="brute", device="cpu")
    with pytest.raises(ValueError, match="stop_radius"):
        brute.query(QS, KnnSpec(3, stop_radius=0.5))
    with pytest.raises(ValueError, match="unknown config key"):
        build_index(PTS, backend="trueknn", growht=2.0)
    with pytest.raises(ValueError, match="unknown metric"):
        brute.query(QS, KnnSpec(3), metric="hamming")
    empty = brute.query(np.empty((0, 3), np.float32), KnnSpec(3))
    assert empty.dists.shape == (0, 3) and empty.timings["plan"] == "empty"


def test_device_knob():
    """``cuda`` is the default and never falls back to the CPU: without a
    card, asking for it raises."""
    assert "device" in build_index.__doc__
    if torch.cuda.is_available():
        index = build_index(PTS, backend="brute")
        assert index.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(PTS, backend="brute")
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(PTS, backend="trueknn", device="cuda")
    cpu = build_index(PTS, backend="brute", device="cpu")
    assert cpu.device.type == "cpu" and cpu.stats()["device"] == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        build_index(PTS, backend="brute", device="mps")
