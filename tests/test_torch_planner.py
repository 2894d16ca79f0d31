"""The port's planner against the JAX package's, route by route.

Every (backend, metric, spec) triple the reference planner serves on
``brute``, ``fixed_radius`` and ``trueknn`` — native hooks, ``l2_view``,
``brute_metric``, ``knn_fallback``, ``knn_filter``, ``knn_sweep`` and
``all_pairs`` — must give the reference's answer bitwise, the same
``timings["plan"]`` tag and the same ``explain()`` tree.  The generic
routes a built-in backend never takes (``knn_fallback``, ``knn_filter``,
``knn_sweep``) run through a knn-only backend registered by the test in
both packages, and the ``run_plan`` cover through one whose native hooks
refuse at run time.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.api.backends.brute as jax_brute
import repro.api.registry as jax_registry
import repro_torch.api.registry as port_registry
from repro_torch import (
    AllPairsSpec,
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
)
from repro_torch.api import NeighborIndex, get_metric, register_backend
from repro_torch.api.backends import BruteIndex, TrueKNNIndex
from torch_trueknn_cases import rounds_of

torch.set_num_threads(1)

METRICS = ["l2", "l1", "linf", "cosine"]
PTS = make_dataset("kitti", 300, seed=5)
QS = make_dataset("kitti", 24, seed=6) + np.float32(0.01)
K = 5
TOL = 1e-4  # the reference's own float32-engine tolerance (test_query.py)


# -- backends the tests register in both packages ---------------------------


def _knn_only(base, neighbor_index):
    """A knn-only backend over ``base`` (each package's BruteIndex): no
    range or hybrid hook, a pre-QueryPlan ``execute_knn`` signature (no
    ctx), no ``stop_radius``, and cosine reached through its L2 view."""

    class KnnOnly(base):
        native_metrics = frozenset({"l2", "l1", "linf"})
        execute_range = neighbor_index.execute_range
        execute_hybrid = neighbor_index.execute_hybrid

        def supports_knn_spec(self, spec):
            return spec.stop_radius is None

        def execute_knn(self, queries, spec, metric):
            return super().execute_knn(queries, spec, metric)

    return KnnOnly


def _refusing(base):
    """Native hooks for every spec kind that refuse at run time (the
    ``run_plan`` cover): range and hybrid always, knn with stop_radius."""

    class Refusing(base):
        def execute_knn(self, queries, spec, metric, ctx=None):
            if spec.stop_radius is not None:
                raise NotImplementedError
            return super().execute_knn(queries, spec, metric, ctx)

        def execute_range(self, queries, spec, metric, ctx=None):
            raise NotImplementedError

        def execute_hybrid(self, queries, spec, metric, ctx=None):
            raise NotImplementedError

    return Refusing


_TEST_BACKENDS = {
    "test_knn_only": (_knn_only(BruteIndex, NeighborIndex),
                      _knn_only(jax_brute.BruteIndex,
                                jax_api.NeighborIndex)),
    "test_refusing": (_refusing(BruteIndex),
                      _refusing(jax_brute.BruteIndex)),
}


@pytest.fixture(scope="module", autouse=True)
def _registered():
    for name, (port_cls, ref_cls) in _TEST_BACKENDS.items():
        register_backend(name)(port_cls)
        jax_api.register_backend(name)(ref_cls)
    yield
    for name in _TEST_BACKENDS:
        port_registry._BACKENDS.pop(name, None)
        jax_registry._BACKENDS.pop(name, None)


# -- helpers ------------------------------------------------------------------


def _radius(metric, pct=50.0, k=K):
    dist = get_metric(metric).pairwise(QS, PTS)
    return float(np.percentile(np.sort(dist, 1)[:, k - 1], pct))


def _jspec(spec):
    if isinstance(spec, KnnSpec):
        return jax_api.KnnSpec(spec.k, start_radius=spec.start_radius,
                               stop_radius=spec.stop_radius)
    if isinstance(spec, HybridSpec):
        return jax_api.HybridSpec(spec.k, spec.radius)
    if isinstance(spec, RangeSpec):
        return jax_api.RangeSpec(spec.radius,
                                 max_neighbors=spec.max_neighbors)
    return jax_api.AllPairsSpec(spec.k, mode=spec.mode, radius=spec.radius,
                                chunk_rows=spec.chunk_rows)


def _pair(backend, **cfg):
    return (build_index(PTS, backend=backend, device="cpu", **cfg),
            jax_api.build_index(PTS, backend=backend, **cfg))


def assert_same(got, want, *, range_tol=False):
    """Bitwise answer and telemetry identity (wall clock excepted).
    ``range_tol``: the dense L2 range of the brute engine, whose distances
    the reference computes in Pallas interpret mode (another float form):
    ball populations and index sets exact, distances to ``TOL``."""
    assert type(got).__name__ == type(want).__name__
    assert got.backend == want.backend and got.metric == want.metric
    assert got.n_tests == want.n_tests
    assert got.timings.get("plan") == want.timings.get("plan")
    assert got.timings.get("plan_inner") == want.timings.get("plan_inner")
    if hasattr(want, "offsets"):
        assert np.array_equal(got.offsets, want.offsets)
        if range_tol:
            for i in range(got.n_queries):
                gi, gd = got.neighbors(i)
                wi, wd = want.neighbors(i)
                assert np.array_equal(np.sort(gi), np.sort(wi))
                np.testing.assert_allclose(gd, wd, rtol=TOL, atol=1e-6)
        else:
            assert np.array_equal(got.idxs, want.idxs)
            assert np.array_equal(got.dists, want.dists)
        assert got.radius == want.radius
        if want.truncated is None:
            assert got.truncated is None
        else:
            assert np.array_equal(got.truncated, want.truncated)
        return
    assert np.array_equal(got.dists, want.dists)
    assert np.array_equal(got.idxs, want.idxs)
    if want.found is None:
        assert got.found is None
    else:
        assert np.array_equal(got.found, want.found)
    assert rounds_of(got) == rounds_of(want)
    assert got.start_radius == want.start_radius
    assert got.final_radius == want.final_radius


def _check(port, ref, spec, metric, queries=(QS, None), **kw):
    """Plan tree, then each query batch, port against reference
    (``"own"``: each index's own resident point array, a self-query)."""
    jspec = _jspec(spec)
    plan = port.prepare(spec, metric=metric)
    assert plan.explain() == ref.prepare(jspec, metric=metric).explain()
    for q in queries:
        own = isinstance(q, str)
        got = port.query(port.points if own else q, spec, metric=metric)
        want = ref.query(ref.points if own else q, jspec, metric=metric)
        assert_same(got, want, **kw)
    return plan.explain()["route"]


# -- the route matrix -------------------------------------------------------

#: the route each (backend, metric) takes for (knn, hybrid, range)
_ROUTES = {
    "fixed_radius": {"l2": ("native",) * 3, "cosine": ("l2_view",) * 3,
                     "l1": ("brute_metric",) * 3,
                     "linf": ("brute_metric",) * 3},
    "trueknn": {"l2": ("native",) * 3, "cosine": ("l2_view",) * 3,
                "l1": ("brute_metric",) * 3, "linf": ("brute_metric",) * 3},
    "test_knn_only": {m: ("native", "knn_filter", "knn_sweep")
                      for m in ("l2", "l1", "linf")}
    | {"cosine": ("l2_view",) * 3},
}


@pytest.mark.parametrize("kind", ["knn", "hybrid", "range"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("backend", list(_ROUTES))
def test_route_matrix(backend, metric, kind):
    r = _radius(metric)
    cfg = {"radius": r} if backend == "fixed_radius" else {}
    port, ref = _pair(backend, **cfg)
    spec = {"knn": KnnSpec(K), "hybrid": HybridSpec(K, r),
            "range": RangeSpec(r)}[kind]
    route = _check(port, ref, spec, metric)
    assert route == _ROUTES[backend][metric][("knn", "hybrid",
                                              "range").index(kind)]
    if route == "l2_view":
        assert port.stats()["metric_views"] == ["cosine"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("backend", ["fixed_radius", "trueknn"])
def test_range_max_neighbors_and_start_radius(backend, metric):
    """Row caps on range, a start radius on kNN: the reference's truncation
    flags and radius semantics on every route."""
    r = _radius(metric, 70.0)
    port, ref = _pair(backend)
    _check(port, ref, RangeSpec(r, max_neighbors=3), metric)
    _check(port, ref, KnnSpec(K, start_radius=_radius(metric, 40.0)), metric,
           queries=(QS,))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_knn_fallback_through_companion_trueknn(metric):
    port, ref = _pair("test_knn_only")
    spec = KnnSpec(K, stop_radius=_radius(metric, 30.0))
    _check(port, ref, spec, metric)
    owner = port.metric_view(get_metric(metric)) if metric == "cosine" \
        else port
    assert isinstance(owner._knn_fallback_view, TrueKNNIndex)
    assert owner._knn_fallback_view.device.type == "cpu"


@pytest.mark.parametrize("kind", ["knn", "hybrid", "range"])
def test_run_plan_covers_hooks_that_refuse(kind):
    port, ref = _pair("test_refusing")
    r = _radius("l2")
    spec = {"knn": KnnSpec(K, stop_radius=r), "hybrid": HybridSpec(K, r),
            "range": RangeSpec(r)}[kind]
    assert _check(port, ref, spec, "l2") == "native"
    tag = port.query(QS, spec).timings["plan"]
    assert tag == {"knn": "knn_fallback", "hybrid": "knn_filter",
                   "range": "knn_sweep"}[kind]


# -- all-pairs ------------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [None, 128])
@pytest.mark.parametrize("mode", ["knn", "range"])
@pytest.mark.parametrize("backend", ["brute", "fixed_radius", "trueknn"])
def test_all_pairs(backend, mode, chunk_rows):
    # a fixed_radius kNN searches its cfg radius
    cfg = ({"radius": _radius("l2", 95.0)}
           if mode == "knn" and backend == "fixed_radius" else {})
    port, ref = _pair(backend, **cfg)
    spec = (AllPairsSpec(K, chunk_rows=chunk_rows) if mode == "knn"
            else AllPairsSpec(mode="range", radius=_radius("l2"),
                              chunk_rows=chunk_rows))
    _check(port, ref, spec, "l2", queries=(None, "own"),
           range_tol=(backend == "brute" and mode == "range"))
    whole = port.query(None, dataclasses.replace(spec, chunk_rows=None))
    part = port.query(None, spec)
    for key in ("dists", "idxs") if mode == "knn" else ("offsets", "idxs",
                                                         "dists"):
        assert np.array_equal(getattr(whole, key), getattr(part, key))


def test_all_pairs_cosine_rides_the_view():
    port, ref = _pair("trueknn")
    for spec in (AllPairsSpec(K), AllPairsSpec(K, chunk_rows=100),
                 AllPairsSpec(mode="range", radius=_radius("cosine"))):
        _check(port, ref, spec, "cosine", queries=(None,))


def test_all_pairs_errors_match():
    port, ref = _pair("trueknn")
    for spec in (AllPairsSpec(len(PTS)),):
        with pytest.raises(ValueError) as got:
            port.query(None, spec)
        with pytest.raises(ValueError) as want:
            ref.query(None, _jspec(spec))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="queries=None"):
        port.query(QS, AllPairsSpec(K))


# -- companions live on the index's device ---------------------------------


def test_companions_on_the_index_device():
    """A CPU index's companions are on the CPU, built by ``build_index``
    or by the backend's constructor (no stashed cfg), and the cfg device
    is never mapped as a radius."""
    cos = get_metric("cosine")
    built = build_index(PTS, backend="fixed_radius", device="cpu", radius=0.3)
    direct = TrueKNNIndex(PTS, device="cpu")
    for index in (built, direct):
        view = index.metric_view(cos)
        assert view.device.type == "cpu"
        assert index.metric_view(cos) is view  # cached
        assert view._build_cfg["device"] == index.device
    assert built.metric_view(cos)._default_radius == pytest.approx(
        np.sqrt(2 * 0.3))
    knn_only = build_index(PTS, backend="test_knn_only", device="cpu")
    knn_only.query(QS, KnnSpec(3, stop_radius=0.5))
    assert knn_only._knn_fallback_view.device.type == "cpu"


def test_stop_radius_on_a_dense_route_raises_like_the_reference():
    port, ref = _pair("trueknn")
    with pytest.raises(ValueError) as got:
        port.prepare(KnnSpec(3, stop_radius=0.5), metric="l1")
    with pytest.raises(ValueError) as want:
        ref.prepare(jax_api.KnnSpec(3, stop_radius=0.5), metric="l1")
    assert str(got.value) == str(want.value)
