"""The port's ``NeighborServer`` over every kind of tenant, against the
JAX package's: the server cases of ``test_mutable.py`` (the write queue:
read-your-writes, cache purge, immutable tenants, write stats and plan
invalidations, write-shape checks), ``test_workloads.py`` (graph and
DBSCAN tickets, their validation and their order against writes),
``test_placement.py`` (placement stats roll-up), ``test_sharded.py``
(the sharded fabric served exactly), ``test_plan.py`` (prepared plans per
tenant) and ``test_fused_loop.py`` (resolved-radius meters), each run on
both packages (the port on the CPU) with the reference test's checks,
then the two packages' served rows and counters required equal.  Last, a
worker-thread drive over three tenants with interleaved writes and a
graph ticket (its card twin, which needs no JAX, is
``test_torch_placement.py::test_cuda_server_worker_thread_equals_cpu``)."""

import numpy as np
import pytest
import torch

from torch_server_cases import PKGS, PORT, both, meters, same, served

torch.set_num_threads(1)


def _cloud(n, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _stable(pkg, mut, qs, spec):
    """A brute rebuild over the mutable tenant's live rows, lifted to
    stable ids: what every read must equal."""
    live_pts, live_ids = mut.snapshot()
    mono = pkg.build(live_pts)
    return pkg.map_to_stable(mono.query(qs, spec), live_ids, mut.sentinel)


def _same_knn(a, b):
    assert np.array_equal(a.dists, b.dists)
    assert np.array_equal(a.idxs, b.idxs)
    assert (a.found is None) == (b.found is None)
    if a.found is not None:
        assert np.array_equal(a.found, b.found)


# -- the write queue (test_mutable.py) ---------------------------------------


def _read_your_writes(pkg):
    pts = _cloud(60)
    mut = pkg.make_mutable(pkg.build(pts), auto_compact="off")
    srv = pkg.NeighborServer(mut)
    qs = _cloud(6, seed=16)
    t_read0 = srv.submit(qs, pkg.KnnSpec(k=4))
    t_ins = srv.submit_insert(_cloud(5, seed=17))
    t_del = srv.submit_delete([2, 8])
    t_read1 = srv.submit(qs, pkg.KnnSpec(k=4))
    r0, minted, n_del, r1 = (t_read0.result(), t_ins.result(),
                             t_del.result(), t_read1.result())
    assert minted.tolist() == [60, 61, 62, 63, 64] and n_del == 2
    _same_knn(r0, pkg.build(pts).query(qs, pkg.KnnSpec(k=4)))
    _same_knn(r1, _stable(pkg, mut, qs, pkg.KnnSpec(k=4)))
    return [served(r0), minted, n_del, served(r1), meters(srv.stats())]


def test_server_read_your_writes():
    both(_read_your_writes)


def _purge(pkg):
    mut = pkg.make_mutable(pkg.build(_cloud(40)), auto_compact="off")
    srv = pkg.NeighborServer(mut, cache_size=64)
    qs = _cloud(3, seed=18)
    srv.submit(qs, pkg.KnnSpec(k=3)).result()
    srv.submit(qs, pkg.KnnSpec(k=3)).result()
    assert srv.stats()["cache"]["hits"] >= 3
    srv.submit_delete([0]).result()
    after = srv.submit(qs, pkg.KnnSpec(k=3)).result()
    assert not np.isin(after.idxs, [0]).any()
    return [served(after), meters(srv.stats())]


def test_server_write_purges_result_cache():
    both(_purge)


def _immutable(pkg):
    srv = pkg.NeighborServer(pkg.build(_cloud(10)))
    t = srv.submit_insert(np.zeros((1, 3), np.float32))
    with pytest.raises(NotImplementedError):
        t.result()
    with pytest.raises(NotImplementedError):
        srv.submit_delete([0]).result()
    return meters(srv.stats())


def test_server_write_rejected_on_immutable_tenant():
    both(_immutable)


def _write_stats(pkg):
    mut = pkg.make_mutable(pkg.build(_cloud(50)), auto_compact="off")
    srv = pkg.NeighborServer(mut)
    qs = _cloud(4, seed=19)
    srv.prepare(pkg.KnnSpec(k=3))
    a = srv.submit(qs, pkg.KnnSpec(k=3)).result()
    srv.submit_insert(_cloud(2, seed=20)).result()
    srv.submit_delete([1]).result()
    b = srv.submit(qs, pkg.KnnSpec(k=3)).result()
    st = srv.stats()
    assert st["writes"]["default"] == {"inserts": 2, "deletes": 1,
                                       "write_ops": 2}
    assert st["plan_cache"]["invalidations"] >= 1
    wbuckets = [v for name, v in st["buckets"].items() if "/write/" in name]
    assert wbuckets and wbuckets[0]["requests"] == 2
    assert st["indexes"]["default"]["tombstones"] == 1
    assert st["indexes"]["default"]["delta_rows"] == 2
    return [served(a), served(b), meters(st)]


def test_server_write_stats_and_plan_invalidations():
    both(_write_stats)


def _write_shapes(pkg):
    srv = pkg.NeighborServer(pkg.make_mutable(pkg.build(_cloud(10))))
    with pytest.raises(ValueError):
        srv.submit_insert(np.zeros((2, 9), np.float32))
    with pytest.raises(ValueError):
        srv.submit_insert(np.zeros((0, 3), np.float32))
    with pytest.raises(ValueError):
        srv.submit_delete([])
    return meters(srv.stats())


def test_server_validates_write_shapes_up_front():
    both(_write_shapes)


# -- workload tickets (test_workloads.py) ------------------------------------

_rng = np.random.default_rng(0)
BLOBS = np.concatenate([
    np.full(3, 100.0 * i, np.float32)
    + _rng.normal(scale=1.0, size=(64, 3)).astype(np.float32)
    for i in range(4)
])
W_PTS = PORT.core.make_dataset("porto", 300, seed=3)


def _graph(g):
    return {k: getattr(g, k) for k in ("indptr", "indices", "dists", "n",
                                       "k", "symmetrize", "generation",
                                       "n_tests")}


def _clusters(c):
    return {k: getattr(c, k) for k in ("labels", "core", "n_clusters",
                                       "n_noise", "n_tests", "eps",
                                       "min_pts")}


def _graph_and_cluster(pkg):
    from importlib import import_module

    wl = import_module(f"{pkg.name}.workloads")
    idx = pkg.build(BLOBS, "trueknn")
    server = pkg.NeighborServer(idx)
    tg = server.submit_graph(6, symmetrize="mutual")
    tc = server.submit_cluster(1.0, 5)
    g, c = tg.result(timeout=120), tc.result(timeout=120)
    direct_g = wl.build_knn_graph(idx, 6, symmetrize="mutual")
    assert np.array_equal(g.indptr, direct_g.indptr)
    assert np.array_equal(g.indices, direct_g.indices)
    assert np.array_equal(c.labels, wl.dbscan(idx, 1.0, 5).labels)
    st = server.stats()
    assert st["workloads"]["default"] == {"graphs": 1, "clusters": 1,
                                          "workload_rows": 2 * len(BLOBS)}
    assert any("/graph/k=6/" in key for key in st["buckets"])
    assert any("/cluster/" in key for key in st["buckets"])
    return [_graph(g), _clusters(c), meters(st)]


def test_server_submit_graph_and_cluster():
    both(_graph_and_cluster)


def _workload_validation(pkg):
    server = pkg.NeighborServer(pkg.build(W_PTS))
    with pytest.raises(ValueError):
        server.submit_graph(0)
    with pytest.raises(ValueError):
        server.submit_graph(3, symmetrize="both")
    with pytest.raises(ValueError):
        server.submit_cluster(-1.0, 4)
    with pytest.raises(ValueError):
        server.submit_cluster(1.0, 0)
    with pytest.raises(KeyError):
        server.submit_graph(3, index="nope")
    return meters(server.stats())


def test_server_workload_validation_fails_fast():
    both(_workload_validation)


def _workload_after_writes(pkg):
    idx = pkg.make_mutable(pkg.build(W_PTS[:100], "trueknn"))
    server = pkg.NeighborServer(idx)
    server.submit_insert(W_PTS[100:140])
    g = server.submit_graph(4).result(timeout=120)
    assert g.n == 140
    assert server.stats()["workloads"]["default"]["workload_rows"] == 140
    return [_graph(g), meters(server.stats())]


def test_server_workload_orders_against_writes():
    both(_workload_after_writes)


# -- placement, sharded, plans, fused loop -----------------------------------

P_PTS = PORT.core.make_dataset("porto", 700, seed=4)
P_QS = np.concatenate([PORT.core.make_dataset("porto", 28, seed=11),
                       np.float32([[40.0, 40.0], [-35.0, 20.0]])])


def _placement_stats(pkg):
    srv = pkg.NeighborServer(
        indexes={"lidar": pkg.build(P_PTS, "sharded", placement="devices",
                                    n_shards=5),
                 "flat": pkg.build(P_PTS[:100])},
        max_batch=64,
    )
    res = srv.submit(P_QS, pkg.KnnSpec(3), index="lidar").result()
    s = srv.stats()
    assert set(s["placement"]["tenants"]) == {"lidar"}
    t = s["placement"]["tenants"]["lidar"]
    assert t["mode"] == "devices" and t["fused_dispatches"] >= 1
    assert s["placement"]["fused_dispatches"] == t["fused_dispatches"]
    assert s["placement"]["rebalances"] == 0
    return [served(res), meters(s)]


def test_server_aggregates_placement_stats():
    both(_placement_stats)


S_PTS = PORT.core.make_dataset("porto", 900, seed=2)
S_QS = np.concatenate([PORT.core.make_dataset("porto", 36, seed=9),
                       np.float32([[40.0, 40.0], [-35.0, 20.0]])])


def _sharded(pkg):
    shard = pkg.build(S_PTS, "sharded", n_shards=5, child_backend="brute")
    direct = shard.query(S_QS, pkg.KnnSpec(4))
    server = pkg.NeighborServer(indexes={"fabric": shard}, cache_size=0)
    got = server.submit(S_QS, pkg.KnnSpec(4), index="fabric").result()
    assert np.array_equal(got.dists, direct.dists)
    assert np.array_equal(got.idxs, direct.idxs)
    assert "fabric/knn/k=4/l2" in server.stats()["buckets"]
    return [served(got), served(direct), meters(server.stats())]


def test_sharded_serves_through_neighbor_server_exactly():
    both(_sharded)


def _plans(pkg):
    pts = pkg.core.make_dataset("porto", 300, seed=6)
    qs = pkg.core.make_dataset("porto", 24, seed=11)
    server = pkg.NeighborServer(
        indexes={"a": pkg.build(pts), "b": pkg.build(pts)}, cache_size=0)
    spec = pkg.KnnSpec(3)
    direct = pkg.build(pts).query(qs, spec)
    for _ in range(3):
        got = server.submit(qs, spec, index="a").result()
    assert np.array_equal(direct.dists, got.dists)
    assert np.array_equal(direct.idxs, got.idxs)
    plans = server.active_plans()
    assert set(plans) == {"a"} and len(plans["a"]) == 1
    assert plans["a"][0]["route"] == "native"
    bucket = server.stats()["buckets"]["a/knn/k=3/l2"]
    assert bucket["plan_cache"]["plans"] == 1
    assert bucket["plan_cache"]["hits"] >= 2
    server.prepare(spec, index="b")
    assert "b" in server.active_plans()
    server.remove_index("b")
    assert "b" not in server.active_plans()
    return [served(got), meters(server.stats())]


def test_server_caches_plans_per_tenant_and_meters_them():
    both(_plans)


F_PTS = PORT.core.make_dataset("porto", 500, seed=4)
F_QS = np.concatenate([PORT.core.make_dataset("porto", 20, seed=11),
                       np.float32([[40.0, 40.0], [-35.0, 20.0]])])


def _resolved_radius(pkg):
    srv = pkg.NeighborServer(pkg.build(F_PTS, "trueknn"), max_batch=64)
    res = srv.submit(F_QS, pkg.KnnSpec(5)).result()
    vals = [b["resolved_radius_p50"] for b in srv.stats()["buckets"].values()]
    assert any(v is not None and v > 0 for v in vals)
    return [served(res), meters(srv.stats())]


def test_server_buckets_report_resolved_radius_p50():
    both(_resolved_radius)


# -- a worker-thread drive over three tenants --------------------------------


def _three_tenants(pkg):
    """Phase 17 of ``chip_smoke.py`` at a small size: a trueknn, a placed
    sharded and a mutable tenant served by the worker thread, with a write
    between reads and a graph ticket; each ticket equals a direct query
    of its rows."""
    from importlib import import_module

    pts = _cloud(600)
    qs = _cloud(40, seed=31)
    lidar = pkg.build(pts, "trueknn")
    placed = pkg.build(pts, "sharded", n_shards=4, placement="devices")
    mut = pkg.make_mutable(pkg.build(pts, "trueknn"), delta_rows=16,
                           auto_compact="off")
    server = pkg.NeighborServer(
        indexes={"lidar": lidar, "placed": placed, "mutable": mut},
        max_batch=16)
    r = 0.4
    specs = (pkg.KnnSpec(8), pkg.HybridSpec(8, r), pkg.RangeSpec(r))
    server.start()
    try:
        singles = [server.submit(q, specs[0], index="lidar") for q in qs]
        multi = {(name, i): server.submit(qs[:24], spec, index=name)
                 for name in ("lidar", "placed", "mutable")
                 for i, spec in enumerate(specs)}
        ins = server.submit_insert(_cloud(20, seed=32) * 0.1,
                                   index="mutable")
        after = server.submit(qs[:24], specs[0], index="mutable")
        dele = server.submit_delete([3, 5, 601], index="mutable")
        after_del = server.submit(qs[:24], specs[0], index="mutable")
        graph = server.submit_graph(8, index="lidar")
        out = {"singles": [t.result(timeout=120) for t in singles],
               "multi": {key: t.result(timeout=120)
                         for key, t in multi.items()},
               "minted": ins.result(timeout=120),
               "after": after.result(timeout=120),
               "deleted": dele.result(timeout=120),
               "after_del": after_del.result(timeout=120),
               "graph": graph.result(timeout=120)}
    finally:
        server.stop()
    direct = lidar.query(qs, specs[0])
    assert np.array_equal(np.vstack([t.dists for t in out["singles"]]),
                          direct.dists)
    assert np.array_equal(np.vstack([t.idxs for t in out["singles"]]),
                          direct.idxs)
    for (name, i), got in out["multi"].items():
        idx = {"lidar": lidar, "placed": placed, "mutable": mut}[name]
        if name == "mutable":
            continue  # read before the write: checked below against a base
        want = idx.query(qs[:24], specs[i])
        same(served(want)["dists"], served(got)["dists"])
        same(served(want)["idxs"], served(got)["idxs"])
    base = pkg.build(pts, "trueknn")
    for i, spec in enumerate(specs):
        want = base.query(qs[:24], spec)
        same(served(want)["dists"], served(out["multi"][("mutable", i)])
             ["dists"])
    assert out["minted"].tolist() == list(range(600, 620))
    assert out["deleted"] == 3
    assert np.array_equal(out["after_del"].dists,
                          _stable(pkg, mut, qs[:24], specs[0]).dists)
    assert np.isin(out["after"].idxs, np.arange(600, 620)).any()
    wl = import_module(f"{pkg.name}.workloads")
    g = wl.build_knn_graph(lidar, 8)
    assert np.array_equal(out["graph"].indices, g.indices)
    s = server.stats()
    assert s["submitted"] == s["served"] and s["rejected"] == 0
    assert s["pending_rows"] == 0 and not s["worker_running"]
    hist = s["buckets"]["lidar/knn/k=8/l2"]["batch_size_hist"]
    assert max(hist) > 1  # single-row requests coalesced
    return {"singles": [served(t) for t in out["singles"]],
            "multi": {f"{k[0]}/{k[1]}": served(v)
                      for k, v in out["multi"].items()},
            "after": served(out["after"]),
            "after_del": served(out["after_del"]),
            "graph": _graph(out["graph"])}


def test_worker_thread_serves_three_tenants_with_writes():
    """Batch composition depends on thread timing, so the two packages'
    tickets are compared row by row (answers do not depend on it)."""
    want, got = (_three_tenants(pkg) for pkg in PKGS)
    for key in ("singles", "after", "after_del", "graph"):
        a, b = want[key], got[key]
        if key == "singles":
            a = [{k: v for k, v in x.items() if k in ("dists", "idxs")}
                 for x in a]
            b = [{k: v for k, v in x.items() if k in ("dists", "idxs")}
                 for x in b]
        elif key != "graph":
            a = {k: a[k] for k in ("dists", "idxs", "found")}
            b = {k: b[k] for k in ("dists", "idxs", "found")}
        same(a, b, key)
    for key in want["multi"]:
        for field in ("dists", "idxs"):
            same(want["multi"][key][field], got["multi"][key][field], key)


def test_scope_is_a_no_op_on_the_cpu():
    from repro_torch._device import device_scope

    with device_scope(torch.device("cpu")), device_scope(None):
        assert torch.zeros(2).device.type == "cpu"
    server = PORT.NeighborServer(PORT.build(_cloud(50)))
    server.start()
    try:
        assert server._streams == {}
    finally:
        server.stop()
