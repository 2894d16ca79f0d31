"""The port's sharded backend (``placement="host"``) and spatial
partitioner against the JAX package's, in one process.

``partition.py`` is a numpy copy, so its outputs are equal.  The
composite's children run on the CPU, where each ported backend
reproduces the reference's float forms, so every answer, plan tag, round
record and counter is ``np.array_equal`` to the reference's, with one
exception that is the brute backend's own: its dense L2 range and its
cosine kNN compute distances in another float form than the reference's
(Pallas interpret mode; a float32 normalization), so brute children are
held where the monolithic brute tests hold them (``tests/test_torch_api.py``:
offsets and index sets exact, distances to the reference tests' 1e-4).
"""

import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core.partition as jax_partition
from repro_torch import (
    AllPairsSpec,
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
)
from repro_torch.api import get_metric
from repro_torch.core import partition as port_partition
from torch_trueknn_cases import rounds_of

torch.set_num_threads(1)

# a uniform cloud keeps the shared-cut rounds (and the reference's
# compiles, one set per round and child) few; 8 morton shards of 32 rows
PTS = make_dataset("uniform", 256, seed=2)
# in-cloud queries plus far-out ones, so radius specs produce a mix of
# full, partial and empty rows
QS = np.concatenate([make_dataset("uniform", 16, seed=9),
                     np.float32([[4.0, 4.0, 4.0], [-3.0, 2.0, 0.5]])])
K = 4
TOL = 1e-4  # the reference's own float32-engine tolerance


def _radius(metric, pct=60.0):
    dist = get_metric(metric).pairwise(QS, PTS)
    return float(np.percentile(np.sort(dist, 1)[:, K - 1], pct))


def _jspec(spec):
    if isinstance(spec, KnnSpec):
        return jax_api.KnnSpec(spec.k, start_radius=spec.start_radius,
                               stop_radius=spec.stop_radius)
    if isinstance(spec, HybridSpec):
        return jax_api.HybridSpec(spec.k, spec.radius)
    if isinstance(spec, RangeSpec):
        return jax_api.RangeSpec(spec.radius,
                                 max_neighbors=spec.max_neighbors)
    return jax_api.AllPairsSpec(spec.k, mode=spec.mode, radius=spec.radius)


def _pair(**cfg):
    return (build_index(PTS, backend="sharded", device="cpu", **cfg),
            jax_api.build_index(PTS, backend="sharded", **cfg))


def _same(got, want, *, tol=False):
    """Answers and telemetry identical (wall clock excepted); ``tol``:
    the brute engine's distances to TOL, offsets and index sets exact."""
    assert type(got).__name__ == type(want).__name__
    assert got.backend == want.backend == "sharded"
    assert got.n_tests == want.n_tests
    for key in ("plan", "plan_inner", "shard_visits", "shard_potential",
                "shard_searches", "self_local_rows", "self_boundary_rows"):
        assert got.timings.get(key) == want.timings.get(key), key
    if hasattr(want, "offsets"):
        assert np.array_equal(got.offsets, want.offsets)
        if want.truncated is None:
            assert got.truncated is None
        else:
            assert np.array_equal(got.truncated, want.truncated)
        if tol:
            for i in range(got.n_queries):
                gi, gd = got.neighbors(i)
                wi, wd = want.neighbors(i)
                assert np.array_equal(np.sort(gi), np.sort(wi))
                np.testing.assert_allclose(gd, wd, rtol=TOL, atol=1e-6)
        else:
            assert np.array_equal(got.idxs, want.idxs)
            assert np.array_equal(got.dists, want.dists)
        return
    if tol:
        np.testing.assert_allclose(got.dists, want.dists, rtol=TOL, atol=1e-6)
        assert np.array_equal(np.sort(got.idxs, 1), np.sort(want.idxs, 1))
    else:
        assert np.array_equal(got.dists, want.dists)
        assert np.array_equal(got.idxs, want.idxs)
    assert np.array_equal(got.found, want.found)
    assert rounds_of(got) == rounds_of(want)
    assert got.final_radius == want.final_radius


_STAT_KEYS = (
    "batches", "queries_served", "shard_visits", "shard_visits_pruned",
    "shard_rounds", "shard_searches", "child_dispatches", "fused_dispatches",
    "rebalances", "self_local_rows", "self_boundary_rows", "n_shards",
    "partition", "child_backend", "shard_sizes", "warm_seed", "prune_rate",
    "placement", "n_points", "dim",
)


def _same_stats(port, ref):
    got, want = port.stats(), ref.stats()
    for key in _STAT_KEYS:
        assert got[key] == want[key], key
    assert got["device"] == "cpu"
    assert [c["backend"] for c in got["children"]] == \
        [c["backend"] for c in want["children"]]


# -- the partitioner ----------------------------------------------------------


@pytest.mark.parametrize("method", ["morton", "grid"])
@pytest.mark.parametrize("n_shards", [1, 7, 8])
def test_partition_equals_reference(method, n_shards):
    got = port_partition.partition_points(PTS, n_shards, method=method)
    want = jax_partition.partition_points(PTS, n_shards, method=method)
    assert got.method == want.method and got.n_shards == want.n_shards
    for a, b in zip(got.shards, want.shards, strict=True):
        assert np.array_equal(a, b)
    for key in ("aabbs", "assign", "sizes"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    for metric in ("l2", "l1", "linf"):
        for fn in ("aabb_min_dists", "aabb_max_dists"):
            assert np.array_equal(
                getattr(port_partition, fn)(got.aabbs, QS, metric),
                getattr(jax_partition, fn)(want.aabbs, QS, metric)), fn


def test_morton_counts_and_occupancy_equal_reference():
    assert np.array_equal(port_partition.morton_codes(PTS),
                          jax_partition.morton_codes(PTS))
    assert np.array_equal(port_partition.morton_codes(PTS, bits=5),
                          jax_partition.morton_codes(PTS, bits=5))
    for args in ((256, 8, 1), (256, 5, 3), (4, 8, 8), (1000, 8, 6)):
        assert (port_partition.balanced_shard_count(*args)
                == jax_partition.balanced_shard_count(*args))
    part = port_partition.partition_points(PTS, 6)
    slot_shard = np.array([0, 1, 2, 3, 4, 5, -1, -1])
    assert (port_partition.shard_occupancy(part.sizes, slot_shard, 4)
            == jax_partition.shard_occupancy(part.sizes, slot_shard, 4))


# -- the composite on the host ------------------------------------------------

#: (child backend, partition, metric, spec kind, queries) cases; the
#: reference compiles per child and shape, so the matrix keeps to what
#: each child route adds
_CASES = [
    ("trueknn", "morton", "l2", "knn", "qs"),
    ("trueknn", "morton", "l2", "knn", "self"),
    ("trueknn", "morton", "l2", "hybrid", "qs"),
    ("trueknn", "morton", "l2", "range", "qs"),
    ("trueknn", "grid", "l2", "knn", "qs"),
    ("trueknn", "grid", "l1", "knn", "qs"),
    ("trueknn", "grid", "l1", "range", "self"),
    ("trueknn", "morton", "cosine", "knn", "qs"),
    ("trueknn", "morton", "cosine", "hybrid", "qs"),
    ("fixed_radius", "morton", "l2", "knn", "qs"),
    ("fixed_radius", "grid", "l2", "hybrid", "qs"),
    ("fixed_radius", "morton", "l2", "range", "self"),
    ("fixed_radius", "morton", "l1", "knn", "qs"),
    ("brute", "morton", "l2", "knn", "self"),
    ("brute", "grid", "l2", "hybrid", "qs"),
    ("brute", "morton", "l2", "range", "qs"),
    ("brute", "morton", "l1", "range", "qs"),
    ("brute", "morton", "cosine", "knn", "qs"),
]


@pytest.mark.parametrize("child,partition,metric,kind,queries", _CASES)
def test_sharded_host_equals_reference(child, partition, metric, kind,
                                       queries):
    r = _radius(metric)
    cfg = {"radius": r} if child == "fixed_radius" else {}
    port, ref = _pair(child_backend=child, partition=partition,
                      child_cfg=cfg)
    spec = {"knn": KnnSpec(K), "hybrid": HybridSpec(K, r),
            "range": RangeSpec(r)}[kind]
    q = QS if queries == "qs" else None
    got = port.query(q, spec, metric=metric)
    want = ref.query(q, _jspec(spec), metric=metric)
    # the brute engine's own float forms (see the module docstring)
    tol = child == "brute" and (metric == "cosine"
                                or (metric == "l2" and kind == "range"))
    _same(got, want, tol=tol)
    assert got.timings["plan"].startswith("sharded/pruned=")
    _same_stats(port, ref)


def test_distributed_children():
    """Children on the distributed backend (one CPU position each): the
    shared-cut rounds hand them ``HybridSpec``s, which their planner
    serves by knn-then-filter.  Two shards and eight rows keep the
    reference's recompiles (one per child round) few."""
    port = build_index(PTS, backend="sharded", device="cpu", n_shards=2,
                       child_backend="distributed")
    ref = jax_api.build_index(PTS, backend="sharded", n_shards=2,
                              child_backend="distributed")
    _same(port.query(QS[:8], KnnSpec(K)),
          ref.query(QS[:8], jax_api.KnnSpec(K)))
    _same_stats(port, ref)
    got = [c["total_tests"] for c in port.stats()["children"]]
    assert got == [c["total_tests"] for c in ref.stats()["children"]]


def test_all_pairs_and_warm_seed_batches():
    """``AllPairsSpec`` (the self-local pre-pass), then a second kNN batch
    on the fused warm seed, with the index's counters after each."""
    port, ref = _pair()
    _same(port.query(None, AllPairsSpec(K)),
          ref.query(None, jax_api.AllPairsSpec(K)))
    _same_stats(port, ref)
    for _ in range(2):
        _same(port.query(QS, KnnSpec(K)), ref.query(QS, jax_api.KnnSpec(K)))
    _same_stats(port, ref)
    assert port.stats()["warm_seed"]["l2"] > 0
    assert port.stats()["self_local_rows"] > 0


def test_range_max_neighbors_and_start_radius():
    r = _radius("l2", 80.0)
    port, ref = _pair()
    spec = RangeSpec(r, max_neighbors=3)
    for q in (QS, None):
        _same(port.query(q, spec), ref.query(q, _jspec(spec)))
    spec = KnnSpec(K, start_radius=_radius("l2", 10.0))
    _same(port.query(QS, spec), ref.query(QS, _jspec(spec)))


def test_stop_radius_takes_the_fallback():
    port, ref = _pair()
    spec = KnnSpec(K, stop_radius=_radius("l2", 30.0))
    got = port.query(QS, spec)
    want = ref.query(QS, _jspec(spec))
    assert got.timings["plan"] == want.timings["plan"] == "knn_fallback"
    assert np.array_equal(got.dists, want.dists)
    assert np.array_equal(got.idxs, want.idxs)
    assert got.n_tests == want.n_tests


def test_prepared_plan_canonical_shapes_and_explain():
    """Under ``prepare()`` per-shard visit-sets pad to canonical pow2
    shapes: the same answers, the same shape buckets and hit counts, the
    same plan tree (per-shard child plans included)."""
    port, ref = _pair()
    for spec in (KnnSpec(K), HybridSpec(K, _radius("l2"))):
        plan = port.prepare(spec)
        jplan = ref.prepare(_jspec(spec))
        assert plan.explain() == jplan.explain()
        for batch in (QS, QS[:9], QS):
            _same(plan(batch), jplan(batch))
        assert plan.cache_stats() == jplan.cache_stats()
    _same_stats(port, ref)


def test_auto_shard_count_on_the_cpu():
    """``n_shards="auto"``: a multiple of the device count of the index's
    device type — one on the CPU, as on a one-device reference."""
    port, ref = _pair(n_shards="auto")
    assert port.n_shards == ref.n_shards == \
        port_partition.balanced_shard_count(len(PTS), 8, 1)
    _same(port.query(QS, KnnSpec(K)), ref.query(QS, jax_api.KnnSpec(K)))


def test_children_live_on_the_index_device():
    """A child cfg naming another device is overridden by the index's."""
    port = build_index(PTS, backend="sharded", device="cpu",
                       child_cfg={"device": "cuda"})
    assert all(c.device.type == "cpu" for c in port._children)
    assert {c["device"] for c in port.stats()["children"]} == {"cpu"}


def test_placement_devices_is_not_ported_yet():
    """``placement="devices"`` is ported now (``test_torch_placement.py``
    holds it against the reference on 1-8 positions): on the one-device
    in-process reference it answers and reports as the reference does.
    Unknown placements and sharded children still raise."""
    port, ref = _pair(placement="devices")
    _same(port.query(QS, KnnSpec(K)), ref.query(QS, jax_api.KnnSpec(K)))
    assert port.stats()["placement"] == ref.stats()["placement"]
    with pytest.raises(ValueError, match="placement"):
        build_index(PTS, backend="sharded", device="cpu", placement="mesh")
    with pytest.raises(ValueError, match="sharded children"):
        build_index(PTS, backend="sharded", device="cpu",
                    child_backend="sharded")

