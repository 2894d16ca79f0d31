"""The port's mutable index (``backend="mutable"``) against the JAX
package's, and against its own rebuilds.

Two oracles:

* **The rebuild** (the reference's own contract, ``tests/test_mutable.py``,
  ported case for case below): every answer equals a monolithic brute
  index of the port built over ``snapshot()``'s live rows, lifted with
  ``map_to_stable`` — ``np.array_equal`` for every metric and spec.
* **The reference**: the same seeded insert / delete / seal / compact
  sequences through ``repro.api`` and the port give the same stable ids,
  ``sentinel``, ``generation``, ``stats()`` and answers.  Indices,
  offsets, ``found`` and truncation flags are ``np.array_equal``, and so
  are distances wherever the port's brute engine reproduces the
  reference's float form (l1, linf, l2 kNN and hybrid).  Where it does not
  — the delta shards' brute L2 range (the reference runs its Pallas kernel
  in interpret mode) and brute cosine — distances are held to the
  reference tests' 1e-4, as ``tests/test_torch_api.py`` holds the brute
  backend itself.

The server's write queue is not ported yet; its cases wait for it.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.workloads as jax_workloads
from repro_torch import (
    CompactionPolicy,
    DeviceMesh,
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
    make_mutable,
    map_to_stable,
)
from repro_torch.api.backends import MutableIndex
from repro_torch.workloads import build_knn_graph, dbscan

torch.set_num_threads(1)

METRICS = ("l2", "l1", "linf", "cosine")
TOL = 1e-4  # the reference's float32-engine tolerance


def _cloud(n, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _mut(pts, **cfg):
    return build_index(pts, backend="mutable", device="cpu", **cfg)


def _same_knn(a, b):
    assert np.array_equal(a.dists, b.dists)
    assert np.array_equal(a.idxs, b.idxs)
    assert (a.found is None) == (b.found is None)
    if a.found is not None:
        assert np.array_equal(a.found, b.found)


def _same_range(a, b):
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.idxs, b.idxs)
    assert np.array_equal(a.dists, b.dists)
    assert (a.truncated is None) == (b.truncated is None)
    if a.truncated is not None:
        assert np.array_equal(a.truncated, b.truncated)


def _assert_identity(mut, qs, specs, metrics=METRICS):
    """Every (metric, spec) answer equals the port's monolithic brute
    rebuild over the same logical snapshot, bit for bit.  Returns the
    rows it queried ``mut`` with."""
    live_pts, live_ids = mut.snapshot()
    mono = build_index(live_pts, backend="brute", device="cpu")
    for metric in metrics:
        for spec in specs:
            got = mut.query(qs, spec, metric=metric)
            want = map_to_stable(
                mono.query(qs, spec, metric=metric), live_ids, mut.sentinel
            )
            if isinstance(spec, RangeSpec):
                _same_range(got, want)
            else:
                _same_knn(got, want)
    return len(qs) * len(metrics) * len(specs)


def _specs(k, r):
    return [KnnSpec(k), RangeSpec(r, max_neighbors=2 * k), HybridSpec(k, r)]


def _jspec(spec):
    if isinstance(spec, KnnSpec):
        return jax_api.KnnSpec(spec.k, start_radius=spec.start_radius,
                               stop_radius=spec.stop_radius)
    if isinstance(spec, HybridSpec):
        return jax_api.HybridSpec(spec.k, spec.radius)
    return jax_api.RangeSpec(spec.radius, max_neighbors=spec.max_neighbors)


def _same_as_ref(got, want, metric, spec):
    """Port vs reference: bitwise but where the brute engine's float form
    differs (L2 range, cosine), there distances to TOL."""
    exact = metric in ("l1", "linf") or (
        metric == "l2" and not isinstance(spec, RangeSpec))
    assert got.backend == want.backend == "mutable"
    assert got.timings["plan"] == want.timings["plan"]
    if isinstance(spec, RangeSpec):
        assert np.array_equal(got.offsets, want.offsets)
        assert np.array_equal(got.idxs, want.idxs)
        assert (got.truncated is None) == (want.truncated is None)
        if got.truncated is not None:
            assert np.array_equal(got.truncated, want.truncated)
    else:
        assert np.array_equal(got.idxs, want.idxs)
        assert (got.found is None) == (want.found is None)
        if got.found is not None:
            assert np.array_equal(got.found, want.found)
    if exact:
        assert np.array_equal(got.dists, want.dists)
    else:
        np.testing.assert_allclose(got.dists, want.dists, rtol=TOL,
                                   atol=1e-6)


_STAT_KEYS = ("n_points", "dim", "generation", "base_backend", "base_rows",
              "delta_shards", "delta_rows", "open_rows", "tombstones",
              "next_id", "auto_compact", "compacting", "inserts", "deletes",
              "compactions", "seals", "queries_served")


def _same_state(port, ref, own_rows=0):
    """Ids, snapshot and counters equal; ``own_rows``: rows the port alone
    was queried with (its rebuild checks)."""
    assert port.sentinel == ref.sentinel
    assert port.generation == ref.generation
    assert port.n_points == ref.n_points
    pp, pi = port.snapshot()
    rp, ri = ref.snapshot()
    assert np.array_equal(pp, rp) and np.array_equal(pi, ri)
    got, want = port.stats(), ref.stats()
    got["queries_served"] -= own_rows
    for key in _STAT_KEYS:
        assert got[key] == want[key], key
    assert got["device"] == "cpu"


def _storm(port, ref, qs, n0, seed, n_ops, check_every, metrics, k, r,
           rebuild_metrics=None):
    """One seeded insert/delete sequence through both packages, answers
    compared every ``check_every`` ops, and against the brute rebuild in
    ``rebuild_metrics`` (default ``metrics``)."""
    rng = np.random.default_rng(seed)
    pool = list(range(n0))
    own = 0
    for op in range(n_ops):
        if pool and rng.random() < 0.4:
            take = int(min(len(pool), 1 + rng.integers(0, 8)))
            sel = sorted(
                map(int, rng.choice(len(pool), size=take, replace=False)),
                reverse=True,
            )
            ids = [pool.pop(i) for i in sel]
            assert port.delete(ids) == ref.delete(ids)
        else:
            m = int(1 + rng.integers(0, 12))
            rows = _cloud(m, d=qs.shape[1], seed=100 + op)
            got, want = port.insert(rows), ref.insert(rows)
            assert got.dtype == np.int64 and np.array_equal(got, want)
            pool.extend(int(i) for i in got)
        if op % check_every == check_every - 1:
            _same_state(port, ref, own)
            for metric in metrics:
                for spec in _specs(k, r):
                    _same_as_ref(port.query(qs, spec, metric=metric),
                                 ref.query(qs, _jspec(spec), metric=metric),
                                 metric, spec)
            own += _assert_identity(port, qs, _specs(k, r),
                                    rebuild_metrics or metrics)
    _same_state(port, ref, own)
    return own


# -- reference parity under seeded write storms -------------------------------


@pytest.mark.parametrize("base", ["brute", "trueknn"])
def test_storm_equals_reference(base):
    """Inserts, deletes, seals and inline compactions through both
    packages: ids, state, counters and every metric's answers.  A trueknn
    base answers cosine through its own ``l2_view`` companion, another
    float form than a brute rebuild's, so that base meets the rebuild in
    the other three metrics."""
    pts, qs = _cloud(150), _cloud(12, seed=5)
    cfg = dict(base_backend=base, delta_rows=24, compact_min_rows=48,
               compact_ratio=0.2, tombstone_ratio=0.15,
               auto_compact="inline")
    port = _mut(pts, **cfg)
    ref = jax_api.build_index(pts, backend="mutable", **cfg)
    _storm(port, ref, qs, 150, seed=4, n_ops=30, check_every=10,
           metrics=METRICS, k=5, r=1.0,
           rebuild_metrics=METRICS if base == "brute" else METRICS[:3])
    assert port.stats()["compactions"] >= 1
    assert port.stats()["seals"] >= 1


def test_grow_from_empty_and_compact_equals_reference():
    """An empty mutable index grows by inserts only (no base rows), then
    an explicit ``compact()`` folds the deltas into a trueknn base."""
    empty = np.empty((0, 3), np.float32)
    cfg = dict(base_backend="trueknn", delta_rows=16, auto_compact="off")
    port = _mut(empty, **cfg)
    ref = jax_api.build_index(empty, backend="mutable", **cfg)
    qs = _cloud(8, seed=31)
    own = _storm(port, ref, qs, 0, seed=7, n_ops=12, check_every=6,
                 metrics=("l2", "l1"), k=4, r=1.2)
    assert port.stats()["base_rows"] == 0 and port.stats()["seals"] >= 1
    assert port.compact() and ref.compact()
    _same_state(port, ref, own)
    assert port.stats()["base_rows"] == port.n_points
    for metric in METRICS:
        for spec in _specs(4, 1.2):
            _same_as_ref(port.query(qs, spec, metric=metric),
                         ref.query(qs, _jspec(spec), metric=metric),
                         metric, spec)


def test_self_query_and_stop_radius_equal_reference():
    pts = _cloud(120)
    port = make_mutable(build_index(pts, backend="trueknn", device="cpu"),
                        auto_compact="off")
    ref = jax_api.make_mutable(jax_api.build_index(pts, backend="trueknn"),
                               auto_compact="off")
    for m in (port, ref):
        m.insert(_cloud(15, seed=12))
        m.delete([0, 11, 125])
    for spec in _specs(3, 1.2):
        _same_as_ref(port.query(None, spec), ref.query(None, _jspec(spec)),
                     "l2", spec)
    qs = _cloud(6, seed=13)
    spec = KnnSpec(4, stop_radius=0.8)
    got, want = port.query(qs, spec), ref.query(qs, _jspec(spec))
    assert got.timings["plan"] == want.timings["plan"] == "mutable/companion"
    _same_knn(got, want)
    _same_state(port, ref)


def test_background_compaction_equals_reference():
    """``auto_compact="background"`` on both sides, joined: the same base,
    the same answers."""
    pts = _cloud(60)
    cfg = dict(base_backend="trueknn", delta_rows=16, compact_min_rows=24,
               compact_ratio=0.2, auto_compact="background")
    port = _mut(pts, **cfg)
    ref = jax_api.build_index(pts, backend="mutable", **cfg)
    for m in (port, ref):
        m.insert(_cloud(40, seed=8))
        m._bg.join(timeout=120)
        assert not m._bg.is_alive()
    _same_state(port, ref)
    assert port.stats()["compactions"] == 1
    qs = _cloud(5, seed=9)
    for spec in _specs(4, 1.0):
        _same_as_ref(port.query(qs, spec), ref.query(qs, _jspec(spec)),
                     "l2", spec)


def test_mutable_over_placed_base_equals_reference():
    """A mutable index over a placed sharded base (the counterpart of
    ``tests/test_placement.py::test_mutable_over_placed_base_recompacts_in_place``):
    the placement survives compaction and every answer equals the
    reference's and the rebuild's."""
    pts = make_dataset("porto", 700, seed=4)
    qs = make_dataset("porto", 20, seed=11)
    extra = make_dataset("porto", 96, seed=21)
    cfg = dict(base_backend="sharded", delta_rows=64, auto_compact="off")
    port = _mut(pts, base_cfg={"n_shards": 4, "placement": "devices",
                               "mesh": DeviceMesh(["cpu"] * 2)}, **cfg)
    ref = jax_api.build_index(
        pts, backend="mutable",
        base_cfg={"n_shards": 4, "placement": "devices"}, **cfg)
    for m in (port, ref):
        m.insert(extra)
        m.delete([3, 700, 701])
    for spec in _specs(4, 0.05):
        _same_as_ref(port.query(qs, spec), ref.query(qs, _jspec(spec)),
                     "l2", spec)
    assert port.compact() and ref.compact()
    _same_state(port, ref)
    assert port.stats()["placement"]["mode"] == "devices"
    assert port.stats()["placement"]["devices"] == 2
    for spec in _specs(4, 0.05):
        _same_as_ref(port.query(qs, spec), ref.query(qs, _jspec(spec)),
                     "l2", spec)
    _assert_identity(port, qs, [KnnSpec(4), HybridSpec(4, 0.05)], ("l2",))


@pytest.mark.parametrize("symmetrize", ["union", "mutual"])
def test_graph_and_dbscan_over_mutable_equal_reference(symmetrize):
    pts = make_dataset("kitti", 300, seed=3)
    cfg = dict(base_backend="trueknn", delta_rows=32, auto_compact="off")
    port = _mut(pts, **cfg)
    ref = jax_api.build_index(pts, backend="mutable", **cfg)
    extra = make_dataset("kitti", 40, seed=9)
    for m in (port, ref):
        m.insert(extra)
        m.delete([1, 5, 302])
    got = build_knn_graph(port, 5, symmetrize=symmetrize)
    want = jax_workloads.build_knn_graph(ref, 5, symmetrize=symmetrize)
    for key in ("indptr", "indices", "dists", "ids"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert (got.n, got.generation) == (want.n, want.generation)
    eps = float(np.quantile(got.dists, 0.3))
    got, want = dbscan(port, eps, 4), jax_workloads.dbscan(ref, eps, 4)
    for key in ("labels", "core", "ids"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert (got.n_clusters, got.generation) == (want.n_clusters,
                                                want.generation)


def test_device_and_adoption_checks():
    base = build_index(_cloud(20), backend="brute", device="cpu")
    mut = make_mutable(base)
    assert mut.device.type == "cpu" and mut.stats()["device"] == "cpu"
    assert mut._snapshot().sources[0].index is base
    mut.insert(_cloud(3, seed=1))
    assert all(s.index.device.type == "cpu"
               for s in mut._snapshot().sources)
    with pytest.raises(NotImplementedError, match="immutable"):
        base.insert(_cloud(1))
    with pytest.raises(NotImplementedError, match="immutable"):
        base.delete([0])


# -- the reference's non-server cases, ported one for one ---------------------


@pytest.mark.parametrize(
    "backend",
    ["brute", "fixed_radius", "trueknn", "distributed", "sharded", "mutable"],
)
def test_empty_build_and_query_shapes(backend):
    idx = build_index(np.empty((0, 3), np.float32), backend=backend,
                      device="cpu")
    assert idx.n_points == 0
    q = np.zeros((4, 3), np.float32)
    knn = idx.query(q, KnnSpec(k=3))
    assert knn.dists.shape == (4, 3) and np.isinf(knn.dists).all()
    assert (knn.idxs == idx.sentinel).all()
    rng_res = idx.query(q, RangeSpec(radius=1.0))
    assert rng_res.offsets.tolist() == [0, 0, 0, 0, 0]
    assert rng_res.idxs.size == 0 and rng_res.dists.size == 0
    hyb = idx.query(q, HybridSpec(2, 1.0))
    assert hyb.dists.shape == (4, 2) and np.isinf(hyb.dists).all()


def test_mutable_grows_from_empty():
    mut = _mut(np.empty((0, 2), np.float32), base_backend="brute")
    assert mut.n_points == 0 and mut.dim == 2
    ids = mut.insert(np.eye(2, dtype=np.float32))
    assert ids.tolist() == [0, 1] and mut.n_points == 2
    res = mut.query(np.zeros((1, 2), np.float32), KnnSpec(k=2))
    assert sorted(res.idxs[0].tolist()) == [0, 1]
    _assert_identity(mut, np.zeros((1, 2), np.float32),
                     _specs(2, 1.5), metrics=("l2",))


def test_insert_returns_monotonic_stable_ids():
    mut = _mut(_cloud(20), base_backend="brute")
    assert mut.sentinel == 20
    a = mut.insert(_cloud(3, seed=1))
    b = mut.insert(_cloud(2, seed=2)[0])  # single (d,) row
    assert a.tolist() == [20, 21, 22] and b.tolist() == [23]
    assert mut.n_points == 24 and mut.sentinel == 24


def test_insert_validates_shape():
    mut = _mut(_cloud(5), base_backend="brute")
    with pytest.raises(ValueError):
        mut.insert(np.zeros((2, 7), np.float32))


def test_delete_unknown_or_dead_id_raises():
    mut = _mut(_cloud(6), base_backend="brute")
    assert mut.delete([1, 3]) == 2
    with pytest.raises(KeyError):
        mut.delete([3])  # already dead
    with pytest.raises(KeyError):
        mut.delete([99])  # never existed
    assert mut.n_points == 4  # failed deletes applied nothing


def test_deleted_rows_never_answer():
    pts = _cloud(30)
    mut = _mut(pts, base_backend="brute")
    mut.delete([0, 5, 7, 29])
    res = mut.query(pts[:8], KnnSpec(k=10))
    assert not np.isin(res.idxs, [0, 5, 7, 29]).any()
    _assert_identity(mut, pts[:4], _specs(4, 1.0), metrics=("l2",))


def test_self_query_identity_after_mutation():
    mut = _mut(_cloud(40), base_backend="brute")
    mut.insert(_cloud(10, seed=3))
    mut.delete([2, 4, 41])
    live_pts, live_ids = mut.snapshot()
    mono = build_index(live_pts, backend="brute", device="cpu")
    for spec in _specs(3, 1.2):
        got = mut.query(None, spec)
        want = map_to_stable(mono.query(None, spec), live_ids, mut.sentinel)
        if isinstance(spec, RangeSpec):
            _same_range(got, want)
        else:
            _same_knn(got, want)


def test_storm_identity_all_metrics_and_specs():
    rng = np.random.default_rng(4)
    qs = _cloud(12, seed=5)
    mut = _mut(_cloud(150), base_backend="brute", delta_rows=24,
               compact_min_rows=48, compact_ratio=0.2, tombstone_ratio=0.15,
               auto_compact="inline")
    pool = list(range(150))
    for op in range(30):
        if pool and rng.random() < 0.4:
            take = int(min(len(pool), 1 + rng.integers(0, 8)))
            sel = sorted(
                map(int, rng.choice(len(pool), size=take, replace=False)),
                reverse=True,
            )
            mut.delete([pool.pop(i) for i in sel])
        else:
            m = int(1 + rng.integers(0, 12))
            pool.extend(int(i) for i in mut.insert(_cloud(m, seed=100 + op)))
        if op % 6 == 5:
            _assert_identity(mut, qs, _specs(5, 1.0))
    assert mut.stats()["compactions"] >= 1  # the storm spanned compactions
    _assert_identity(mut, qs, _specs(5, 1.0))


def test_mid_compaction_identity():
    """Reads served while a compaction is parked between base-rebuild and
    swap must equal the pre-swap logical snapshot; post-swap too."""
    qs = _cloud(6, seed=6)
    mut = _mut(_cloud(80), base_backend="brute", delta_rows=16,
               auto_compact="off")
    mut.insert(_cloud(20, seed=7))
    mut.delete([1, 9, 85])
    built, release = threading.Event(), threading.Event()

    def parked(_index):
        built.set()
        release.wait(timeout=60)

    mut._on_compact_built = parked
    t = threading.Thread(target=mut.compact, daemon=True)
    t.start()
    assert built.wait(timeout=60)
    try:
        assert mut.stats()["compacting"]
        assert mut.compact() is False  # in-flight guard
        _assert_identity(mut, qs, _specs(4, 1.0), metrics=("l2", "cosine"))
    finally:
        release.set()
        t.join()
    mut._on_compact_built = None
    st = mut.stats()
    assert st["compactions"] == 1 and st["delta_shards"] == 0
    assert st["tombstones"] == 0  # consumed tombstones retired
    _assert_identity(mut, qs, _specs(4, 1.0), metrics=("l2", "cosine"))


def test_background_compaction():
    mut = _mut(_cloud(60), base_backend="brute", delta_rows=16,
               compact_min_rows=24, compact_ratio=0.2,
               auto_compact="background")
    mut.insert(_cloud(40, seed=8))
    deadline = threading.Event()
    for _ in range(200):  # rebuild runs on a daemon thread
        if mut.stats()["compactions"] >= 1:
            break
        deadline.wait(0.02)
    st = mut.stats()
    assert st["compactions"] >= 1
    assert st["base_rows"] == 100
    _assert_identity(mut, _cloud(5, seed=9), _specs(4, 1.0), metrics=("l2",))


def test_compaction_policy_due():
    p = CompactionPolicy(min_rows=100, ratio=0.5, tombstone_ratio=0.2)
    assert not p.due(1000, 0, 0)
    assert not p.due(1000, 400, 0)   # below max(100, 500)
    assert p.due(1000, 500, 0)
    assert not p.due(1000, 50, 100)  # tombs below 0.2 * 1050
    assert p.due(1000, 50, 210)
    with pytest.raises(ValueError):
        CompactionPolicy(mode="sometimes")


def test_make_mutable_adopts_without_rebuild():
    base = build_index(_cloud(100), backend="trueknn", device="cpu")
    mut = make_mutable(base, delta_rows=32, auto_compact="off")
    assert isinstance(mut, MutableIndex)
    assert mut._base is base  # adopted, not rebuilt
    assert mut.n_points == 100 and mut.sentinel == 100
    mut.insert(_cloud(10, seed=10))
    mut.delete([3, 103])
    # trueknn base: l2 knn/hybrid are bitwise vs a brute monolith
    live_pts, live_ids = mut.snapshot()
    mono = build_index(live_pts, backend="brute", device="cpu")
    qs = _cloud(8, seed=11)
    for spec in (KnnSpec(4), HybridSpec(4, 1.0)):
        got = mut.query(qs, spec)
        want = map_to_stable(mono.query(qs, spec), live_ids, mut.sentinel)
        _same_knn(got, want)
    assert make_mutable(mut) is mut  # passthrough
    with pytest.raises(ValueError):
        make_mutable(mut, delta_rows=64)  # knobs only at build time


def test_mutable_rejects_mutable_base():
    with pytest.raises(ValueError):
        _mut(_cloud(10), base_backend="mutable")


def test_stop_radius_uses_companion():
    mut = make_mutable(build_index(_cloud(120), backend="trueknn",
                                   device="cpu"), auto_compact="off")
    mut.insert(_cloud(15, seed=12))
    mut.delete([0, 11])
    qs = _cloud(6, seed=13)
    spec = KnnSpec(4, stop_radius=0.8)
    got = mut.query(qs, spec)
    assert got.timings["plan"] == "mutable/companion"
    live_pts, live_ids = mut.snapshot()
    mono = build_index(live_pts, backend="trueknn", device="cpu")
    want = map_to_stable(mono.query(qs, spec), live_ids, mut.sentinel)
    _same_knn(got, want)


def test_plan_self_invalidates_on_mutation():
    mut = _mut(_cloud(50), base_backend="brute", auto_compact="off")
    plan = mut.prepare(KnnSpec(k=3))
    qs = _cloud(5, seed=14)
    plan(qs)
    assert plan.cache_stats()["invalidations"] == 0
    mut.insert(_cloud(4, seed=15))
    res = plan(qs)  # transparently re-prepares against the new generation
    assert plan.cache_stats()["invalidations"] == 1
    _assert_identity(mut, qs, [KnnSpec(k=3)], metrics=("l2",))
    live_pts, live_ids = mut.snapshot()
    mono = build_index(live_pts, backend="brute", device="cpu")
    want = map_to_stable(mono.query(qs, KnnSpec(k=3)), live_ids, mut.sentinel)
    _same_knn(res, want)
    assert plan.explain()["generation"] == mut.generation


def test_map_to_stable_maps_positions_and_sentinel():
    mut = _mut(_cloud(10), base_backend="brute")
    mut.delete([0, 3])
    live_pts, live_ids = mut.snapshot()
    assert live_ids.tolist() == [1, 2, 4, 5, 6, 7, 8, 9]
    mono = build_index(live_pts, backend="brute", device="cpu")
    res = mono.query(_cloud(2, seed=21), KnnSpec(k=10))  # k > live: padding
    lifted = map_to_stable(res, live_ids, mut.sentinel)
    pad = ~np.isfinite(res.dists)
    assert (lifted.idxs[pad] == mut.sentinel).all()
    assert np.array_equal(
        lifted.idxs[~pad], live_ids[res.idxs[~pad]].astype(np.int32)
    )
    want = jax_api.map_to_stable(res, live_ids, mut.sentinel)
    assert np.array_equal(lifted.idxs, want.idxs)
