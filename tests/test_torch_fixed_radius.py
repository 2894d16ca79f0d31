"""The port's ``fixed_radius`` backend (paper Alg. 1) against the JAX
package's: kNN, hybrid and range in the four metrics, the per-radius grid
LRU, the cfg radius as a bound on every metric route (mapped into the
cosine view), and the reference's error messages.  On the CPU the grid
round runs its plain version, which reproduces the reference's float
forms, so answers and counters are ``np.array_equal``."""

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro_torch import (
    AllPairsSpec,
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
)
from repro_torch.api import get_metric
from torch_trueknn_cases import rounds_of

torch.set_num_threads(1)

METRICS = ["l2", "l1", "linf", "cosine"]
PTS = make_dataset("kitti", 400, seed=2)
QS = make_dataset("kitti", 32, seed=3) + np.float32(0.005)
K = 6


def _radius(metric, pct=60.0):
    dist = get_metric(metric).pairwise(QS, PTS)
    return float(np.percentile(np.sort(dist, 1)[:, K - 1], pct))


def _pair(**cfg):
    return (build_index(PTS, backend="fixed_radius", device="cpu", **cfg),
            jax_api.build_index(PTS, backend="fixed_radius", **cfg))


def _same_knn(got, want):
    assert np.array_equal(got.dists, want.dists)
    assert np.array_equal(got.idxs, want.idxs)
    assert np.array_equal(got.found, want.found)
    assert got.n_tests == want.n_tests
    assert rounds_of(got) == rounds_of(want)
    assert got.timings.get("plan") == want.timings.get("plan")
    for key in ("grid_builds", "grid_cache_hits"):
        assert got.timings.get(key) == want.timings.get(key), key


def _same_range(got, want):
    for key in ("offsets", "idxs", "dists"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert got.n_tests == want.n_tests
    for key in ("plan", "count_rounds", "grid_builds", "grid_cache_hits"):
        assert got.timings.get(key) == want.timings.get(key), key


@pytest.mark.parametrize("metric", METRICS)
def test_knn_with_the_cfg_radius(metric):
    r = _radius(metric)
    port, ref = _pair(radius=r)
    for q in (QS, None):
        _same_knn(port.query(q, KnnSpec(K), metric=metric),
                  ref.query(q, jax_api.KnnSpec(K), metric=metric))
    # a spec radius overrides the cfg one
    small = _radius(metric, 20.0)
    _same_knn(port.query(QS, KnnSpec(K, start_radius=small), metric=metric),
              ref.query(QS, jax_api.KnnSpec(K, start_radius=small),
                        metric=metric))


@pytest.mark.parametrize("metric", METRICS)
def test_hybrid(metric):
    r = _radius(metric)
    port, ref = _pair()
    for q in (QS, None):
        got = port.query(q, HybridSpec(K, r), metric=metric)
        _same_knn(got, ref.query(q, jax_api.HybridSpec(K, r), metric=metric))
    assert (got.found < K).any() and (got.found >= K).any()


@pytest.mark.parametrize("metric", METRICS)
def test_range(metric):
    r = _radius(metric)
    port, ref = _pair()
    for q in (QS, None):
        got = port.query(q, RangeSpec(r), metric=metric)
        _same_range(got, ref.query(q, jax_api.RangeSpec(r), metric=metric))
    capped = port.query(QS, RangeSpec(r, max_neighbors=2), metric=metric)
    want = ref.query(QS, jax_api.RangeSpec(r, max_neighbors=2), metric=metric)
    _same_range(capped, want)
    assert np.array_equal(capped.truncated, want.truncated)
    assert capped.truncated.any()


def test_native_range_takes_a_second_counted_round():
    """A ball fuller than the first round's k (32) sizes a second round
    from the exact in-ball counts."""
    r = _radius("l2", 99.0) * 3
    port, ref = _pair()
    got = port.query(QS, RangeSpec(r))
    _same_range(got, ref.query(QS, jax_api.RangeSpec(r)))
    assert got.timings["count_rounds"] == 2 and got.counts.max() > 32


def test_grid_lru_across_batches():
    """One grid per radius, cached across batches, evicted least recently
    used past ``max_cached_grids``."""
    r = _radius("l2")
    port, ref = _pair(radius=r, max_cached_grids=2)
    a = port.query(PTS[:100], KnnSpec(5))
    b = port.query(PTS[100:200], KnnSpec(5))
    assert a.timings["grid_builds"] == 1
    assert b.timings["grid_builds"] == 0 and b.timings["grid_cache_hits"] == 1
    specs = [KnnSpec(5), HybridSpec(5, r * 2), RangeSpec(r * 3),
             HybridSpec(5, r), KnnSpec(5)]
    ref.query(PTS[:100], jax_api.KnnSpec(5))
    ref.query(PTS[100:200], jax_api.KnnSpec(5))
    for spec in specs:
        got = port.query(QS, spec)
        if isinstance(spec, RangeSpec):
            _same_range(got, ref.query(QS, jax_api.RangeSpec(spec.radius)))
        elif isinstance(spec, HybridSpec):
            _same_knn(got, ref.query(QS, jax_api.HybridSpec(5, spec.radius)))
        else:
            _same_knn(got, ref.query(QS, jax_api.KnnSpec(5)))
    want = ref.stats()
    got = port.stats()
    for key in ("grid_builds", "grid_cache_hits", "cached_grids",
                "metric_views"):
        assert got[key] == want[key], key
    assert got["cached_grids"] == 2 and got["grid_builds"] == 4


def test_cfg_radius_bounds_every_metric_and_maps_into_the_view():
    """The cfg radius is in query-metric units: it bounds KnnSpec answers
    on every route (native l2, cosine through the L2 view, l1 / linf
    through the dense engine), and the cosine companion searches the
    mapped L2 ball sqrt(2 r)."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    qs = rng.normal(size=(20, 3)).astype(np.float32)
    for metric, r in (("l2", 0.6), ("l1", 0.9), ("linf", 0.5),
                      ("cosine", 0.3)):
        port = build_index(pts, backend="fixed_radius", device="cpu",
                           radius=r)
        ref = jax_api.build_index(pts, backend="fixed_radius", radius=r)
        got = port.query(qs, KnnSpec(4), metric=metric)
        _same_knn(got, ref.query(qs, jax_api.KnnSpec(4), metric=metric))
        assert np.all(got.dists[np.isfinite(got.dists)] <= r)
        if metric == "cosine":
            view = port._metric_views["cosine"]
            assert view._default_radius == ref._metric_views[
                "cosine"]._default_radius
            assert view._default_radius == pytest.approx(np.sqrt(2 * r))
            assert view.device.type == "cpu"
            assert port.stats()["metric_views"] == ["cosine"]


@pytest.mark.parametrize("metric,spec", [
    ("l2", KnnSpec(4)),
    ("l1", KnnSpec(4)),
    ("cosine", KnnSpec(4)),
    ("l2", KnnSpec(4, stop_radius=0.5)),
])
def test_reference_errors(metric, spec):
    port = build_index(PTS, backend="fixed_radius", device="cpu")
    ref = jax_api.build_index(PTS, backend="fixed_radius")
    jspec = jax_api.KnnSpec(spec.k, stop_radius=spec.stop_radius)
    with pytest.raises(ValueError) as got:
        port.query(QS, spec, metric=metric)
    with pytest.raises(ValueError) as want:
        ref.query(QS, jspec, metric=metric)
    assert str(got.value) == str(want.value)


def test_unknown_cfg_key_names_the_knobs():
    with pytest.raises(ValueError, match=r"radius_.*valid knobs.*radius"):
        build_index(PTS, backend="fixed_radius", device="cpu", radius_=0.1)



def test_range_tie_order_follows_each_backends_grid():
    """Neighbors at equal distance come in the order of their slots in the
    grid that found them, as in the reference: a trueknn index whose
    lattice snaps the radius onto another grid shape lists ties in
    another order than ``fixed_radius`` at the exact radius.  Offsets and
    distances agree bitwise, indices once rows are ordered by (dist, idx),
    and each backend equals its reference counterpart exactly."""
    lattice = np.stack(np.meshgrid(*[np.arange(7)] * 3), -1).reshape(-1, 3)
    lattice = lattice.astype(np.float32)  # 343 points, many exact ties
    spec, jspec = AllPairsSpec(mode="range", radius=1.5), \
        jax_api.AllPairsSpec(mode="range", radius=1.5)
    got, want = {}, {}
    for backend in ("trueknn", "fixed_radius"):
        port = build_index(lattice, backend=backend, device="cpu")
        ref = jax_api.build_index(lattice, backend=backend)
        if backend == "trueknn":  # anchor the lattice at a kNN batch first
            port.query(None, KnnSpec(4))
            ref.query(None, jax_api.KnnSpec(4))
        got[backend] = port.query(None, spec)
        want[backend] = ref.query(None, jspec)
        _same_range(got[backend], want[backend])
    a, b = got["trueknn"], got["fixed_radius"]
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.dists, b.dists)
    assert not np.array_equal(a.idxs, b.idxs)
    rows = np.repeat(np.arange(a.n_queries), a.counts)
    assert np.array_equal(a.idxs[np.lexsort((a.idxs, a.dists, rows))],
                          b.idxs[np.lexsort((b.idxs, b.dists, rows))])
