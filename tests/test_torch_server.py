"""The port's ``NeighborServer`` against the JAX package's: the server
cases of ``tests/test_server.py``, each run on both packages (the port on
the CPU).  Every case keeps the reference test's own checks (served
results equal a direct ``index.query``, coalescing, FIFO scheduling,
the cache and its quantization caveat, admission control, multi-tenant
routing) and then requires the two packages' served rows, CSRs, timing
tags and server counters to be equal (``torch_server_cases.same``;
latencies are compared by structure only)."""

import threading
import time

import numpy as np
import pytest
import torch

from torch_server_cases import PORT, both, meters, served

torch.set_num_threads(1)

PTS = PORT.core.make_dataset("porto", 1200, seed=4)
QS = PORT.core.make_dataset("porto", 48, seed=11)
RADIUS = 0.5


# ------------------------------------------------ served == direct query


def _interleaved(pkg):
    index = pkg.build(PTS)
    direct = {
        ("knn", "l2"): index.query(QS, pkg.KnnSpec(5)),
        ("hyb", "l2"): index.query(QS, pkg.HybridSpec(5, RADIUS)),
        ("knn", "l1"): index.query(QS, pkg.KnnSpec(5), metric="l1"),
    }
    server = pkg.NeighborServer(pkg.build(PTS))
    t1 = server.submit(QS[:20], pkg.KnnSpec(5))
    t2 = server.submit(QS, pkg.HybridSpec(5, RADIUS))
    t3 = server.submit(QS[:16], pkg.KnnSpec(5), metric="l1")
    t4 = server.submit(QS[20:], pkg.KnnSpec(5))
    t5 = server.submit(QS[16:], pkg.KnnSpec(5), metric="l1")
    got_knn_d = np.vstack([t1.result().dists, t4.result().dists])
    got_knn_i = np.vstack([t1.result().idxs, t4.result().idxs])
    assert np.array_equal(got_knn_d, direct[("knn", "l2")].dists)
    assert np.array_equal(got_knn_i, direct[("knn", "l2")].idxs)
    hyb = t2.result()
    assert np.array_equal(hyb.dists, direct[("hyb", "l2")].dists)
    assert np.array_equal(hyb.idxs, direct[("hyb", "l2")].idxs)
    assert np.array_equal(hyb.found, direct[("hyb", "l2")].found)
    assert hyb.metric == "l2" and hyb.backend == "brute"
    got_l1_d = np.vstack([t3.result().dists, t5.result().dists])
    assert np.array_equal(got_l1_d, direct[("knn", "l1")].dists)
    assert t3.result().metric == "l1"
    return {"tickets": [served(t.result()) for t in (t1, t2, t3, t4, t5)],
            "stats": meters(server.stats())}


def test_server_matches_direct_interleaved_specs_and_metrics():
    both(_interleaved)


def _range_csr(pkg):
    index = pkg.build(PTS, "trueknn")
    spec = pkg.RangeSpec(RADIUS, max_neighbors=8)
    direct = index.query(QS, spec)
    server = pkg.NeighborServer(pkg.build(PTS, "trueknn"))
    ra = server.submit(QS[:30], spec).result()
    rb = server.submit(QS[30:], spec).result()
    for key in ("dists", "idxs", "counts", "truncated"):
        assert np.array_equal(
            np.concatenate([getattr(ra, key), getattr(rb, key)]),
            getattr(direct, key)), key
    assert ra.radius == direct.radius
    for i in range(ra.n_queries):
        _, d = ra.neighbors(i)
        assert np.all(np.diff(d) >= 0)
    return {"a": served(ra), "b": served(rb), "direct": served(direct)}


def test_server_range_spec_csr_matches_direct():
    both(_range_csr)


def _worker_thread(pkg):
    index = pkg.build(PTS)
    direct = index.query(QS[:16], pkg.KnnSpec(4))
    server = pkg.NeighborServer(index)
    server.start()
    try:
        tickets = [server.submit(QS[i], pkg.KnnSpec(4)) for i in range(16)]
        outs = [t.result(timeout=60) for t in tickets]
    finally:
        server.stop()
    got = np.vstack([o.dists for o in outs])
    assert np.array_equal(got, direct.dists)
    assert np.array_equal(np.vstack([o.idxs for o in outs]), direct.idxs)
    assert all(o.dists.shape == (1, 4) for o in outs)
    s = server.stats()
    assert s["submitted"] == s["served"] == 16 and not s["worker_running"]
    return {"dists": got, "direct": served(direct)}


def test_server_single_row_submit_and_worker_thread():
    both(_worker_thread)


# ------------------------------------------------------- microbatching


def _coalesce(pkg):
    server = pkg.NeighborServer(pkg.build(PTS))
    tickets = [server.submit(QS[i], pkg.KnnSpec(3)) for i in range(6)]
    assert not any(t.done() for t in tickets)
    assert server.stats()["pending_rows"] == 6
    res = tickets[0].result()
    assert res.timings["server_batch_rows"] == 6
    assert all(t.done() for t in tickets)
    bucket = server.stats()["buckets"]["default/knn/k=3/l2"]
    assert bucket["batches"] == 1
    assert bucket["batch_size_hist"] == {6: 1}
    assert bucket["mean_batch_rows"] >= 2
    return {"tickets": [served(t.result()) for t in tickets],
            "stats": meters(server.stats())}


def test_server_coalesces_pending_requests_into_one_batch():
    both(_coalesce)


def _identical_specs(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    a = server.submit(QS[:4], pkg.KnnSpec(3))
    b = server.submit(QS[:4], pkg.KnnSpec(4))
    server.drain()
    assert a.result().dists.shape == (4, 3)
    assert b.result().dists.shape == (4, 4)
    buckets = server.stats()["buckets"]
    assert buckets["default/knn/k=3/l2"]["batches"] == 1
    assert buckets["default/knn/k=4/l2"]["batches"] == 1
    return [served(a.result()), served(b.result()), meters(server.stats())]


def test_server_batches_only_merge_identical_specs():
    both(_identical_specs)


def _oldest_first(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    old = server.submit(QS[:1], pkg.KnnSpec(3))
    time.sleep(0.005)
    young = [server.submit(QS[i], pkg.KnnSpec(4)) for i in range(5)]
    server.step()
    assert old.done()
    assert not any(t.done() for t in young)
    server.drain()
    assert all(t.done() for t in young)
    return [served(t.result()) for t in [old] + young]


def test_step_serves_oldest_head_first_no_starvation():
    both(_oldest_first)


def _max_batch(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), max_batch=16, cache_size=0)
    res = server.submit(QS, pkg.KnnSpec(3)).result()
    assert res.dists.shape == (48, 3)
    bucket = server.stats()["buckets"]["default/knn/k=3/l2"]
    assert bucket["batches"] == 3
    assert all(size <= 16 for size in bucket["batch_size_hist"])
    return [served(res), meters(server.stats())]


def test_server_max_batch_splits_oversized_queues():
    both(_max_batch)


def _worker_dies(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    t = server.submit(QS[:2], pkg.KnnSpec(3))
    dummy = threading.Thread(target=time.sleep, args=(0.3,))
    dummy.start()
    server._worker = dummy  # looks alive, will die having served nothing
    res = t.result(timeout=30)
    assert res.dists.shape == (2, 3)
    dummy.join()
    server._worker = None
    return served(res)


def test_result_recovers_when_worker_dies_without_draining():
    both(_worker_dies)


def _failed_batch(pkg):
    server = pkg.NeighborServer(pkg.build(PTS, "trueknn"))
    t = server.submit(QS[:4], pkg.KnnSpec(len(PTS) + 10))  # k > N: raises
    # the reference asserts k <= N; the port raises ValueError
    with pytest.raises(AssertionError if pkg.name == "repro" else ValueError,
                       match=None if pkg.name == "repro" else "k must be"):
        t.result(timeout=30)
    assert t.done()
    assert server.stats()["pending_rows"] == 0
    ok = server.submit(QS[:4], pkg.KnnSpec(3)).result()
    assert ok.dists.shape == (4, 3)
    return [served(ok), meters(server.stats())]


def test_server_failed_batch_fails_tickets_instead_of_hanging():
    both(_failed_batch)


def _validation(pkg):
    server = pkg.NeighborServer(pkg.build(PTS))
    with pytest.raises(TypeError, match="QuerySpec"):
        server.submit(QS, 5)
    with pytest.raises(ValueError, match="queries must be"):
        server.submit(np.zeros((3, 7), np.float32), pkg.KnnSpec(2))
    with pytest.raises(ValueError, match="empty"):
        server.submit(np.zeros((0, PTS.shape[1]), np.float32),
                      pkg.KnnSpec(2))
    return meters(server.stats())


def test_server_submit_validation():
    both(_validation)


# --------------------------------------------------------------- cache


def _cache_exact(pkg):
    server = pkg.NeighborServer(pkg.build(PTS))
    first = server.submit(QS[:8], pkg.KnnSpec(5)).result()
    assert first.timings["plan"] != "cache"
    again = server.submit(QS[:8], pkg.KnnSpec(5))
    assert again.done()
    res = again.result()
    assert res.timings["plan"] == "cache"
    assert res.timings["server_cache_hits"] == 8
    assert np.array_equal(res.dists, first.dists)
    assert np.array_equal(res.idxs, first.idxs)
    nudged = QS[:1] + np.float32(server.cache_quant * 0.25)
    hit = server.submit(nudged, pkg.KnnSpec(5)).result()
    assert hit.timings["plan"] == "cache"
    assert np.array_equal(hit.dists, first.dists[:1])
    miss = server.submit(QS[:1], pkg.KnnSpec(5), metric="l1").result()
    assert miss.timings["plan"] != "cache"
    return [served(r) for r in (first, res, hit, miss)] + [
        meters(server.stats())]


def test_server_cache_hits_are_exact_and_quantized():
    both(_cache_exact)


def _cache_bound(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    server.submit(QS[:4], pkg.KnnSpec(3)).result()
    r = server.submit(QS[:4], pkg.KnnSpec(3)).result()
    assert r.timings["plan"] != "cache"
    assert server.stats()["cache"]["rows"] == 0
    small = pkg.NeighborServer(pkg.build(PTS), cache_size=8)
    s = small.submit(QS[:32], pkg.KnnSpec(3)).result()
    assert small.stats()["cache"]["rows"] == 8
    return [served(r), served(s), meters(small.stats())]


def test_server_cache_disabled_and_lru_bound():
    both(_cache_bound)


# --------------------------------------------------------------- stats


def _reconcile(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    reqs = [
        (QS[:10], pkg.KnnSpec(4), "l2"),
        (QS[10:25], pkg.KnnSpec(4), "l2"),
        (QS[:6], pkg.HybridSpec(4, RADIUS), "l2"),
        (QS[:5], pkg.KnnSpec(4), "l1"),
    ]
    tickets = [server.submit(q, s, metric=m) for q, s, m in reqs]
    served_rows = server.drain()
    assert all(t.done() for t in tickets)
    s = server.stats()
    assert s["submitted"] == s["served"] == len(reqs)
    assert s["pending_rows"] == 0
    assert served_rows == sum(len(q) for q, _, _ in reqs)
    assert sum(b["requests"] for b in s["buckets"].values()) == len(reqs)
    assert sum(b["rows"] for b in s["buckets"].values()) == served_rows
    assert s["cache"]["misses"] == served_rows
    knn_l2 = s["buckets"]["default/knn/k=4/l2"]
    assert knn_l2["requests"] == 2 and knn_l2["rows"] == 25
    assert knn_l2["latency_p50_ms"] is not None
    assert knn_l2["latency_p99_ms"] >= knn_l2["latency_p50_ms"]
    assert knn_l2["queue_depth"] == 0
    return [served(t.result()) for t in tickets] + [meters(s)]


def test_server_stats_reconcile_with_submissions():
    both(_reconcile)


# ------------------------------------ warm radius + dropped counters


def _warm_truncated(pkg):
    pts = pkg.core.make_dataset("porto", 900, seed=3)
    qs = pkg.core.make_dataset("porto", 64, seed=21)
    index = pkg.build(pts, "trueknn")
    warm = index.query(qs, pkg.KnnSpec(5, stop_radius=0.05))
    assert np.isinf(warm.dists[:, -1]).any()
    r = pkg.warm_default_radius(warm.dists, index)
    assert np.isfinite(r) and r > 0
    fin = warm.dists[:, -1][np.isfinite(warm.dists[:, -1])]
    assert r == pytest.approx(float(np.median(fin.astype(np.float64))))
    pkg.HybridSpec(5, r)
    return {"warm": served(warm), "r": r}


def test_warm_default_radius_finite_under_truncated_warm_batch():
    both(_warm_truncated)


def _warm_all_inf(pkg):
    pts = pkg.core.make_dataset("uniform", 500, seed=2)
    index = pkg.build(pts, "trueknn")
    all_inf = np.full((16, 4), np.inf, np.float32)
    r = pkg.warm_default_radius(all_inf, index)
    assert np.isfinite(r) and r > 0
    assert r == pytest.approx(float(pkg.core.sample_start_radius(pts)))
    index.query(pts[:32], pkg.KnnSpec(3))
    assert index._sampled_r is not None
    r2 = pkg.warm_default_radius(all_inf, index)
    assert r2 == pytest.approx(float(index._sampled_r))
    with pytest.raises(ValueError, match="sampled radius"):
        pkg.warm_default_radius(all_inf)
    return [r, r2]


def test_warm_default_radius_all_inf_falls_back_to_sampled():
    both(_warm_all_inf)


def test_warm_default_radius_samples_the_resident_tensor(monkeypatch):
    """The port's fallback samples the index's resident tensor (on its
    device), never a numpy copy, and a mutable index's live rows."""
    from repro_torch.core import sampling

    seen = []
    real = sampling.sample_start_radius

    def spy(points, **kw):
        seen.append(points)
        return real(points, **kw)

    monkeypatch.setattr(sampling, "sample_start_radius", spy)
    pts = PORT.core.make_dataset("uniform", 500, seed=2)
    all_inf = np.full((4, 3), np.inf, np.float32)
    index = PORT.build(pts, "trueknn")
    r = PORT.warm_default_radius(all_inf, index)
    assert seen[-1] is index._pts_t
    mut = PORT.make_mutable(PORT.build(pts, "brute"), auto_compact="off")
    mut.delete(list(range(100)))
    r_mut = PORT.warm_default_radius(all_inf, mut)
    assert isinstance(seen[-1], torch.Tensor)
    assert np.array_equal(seen[-1].numpy(), pts[100:])
    assert r_mut == real(pts[100:]) and r == real(pts)


def _dropped(pkg):
    dists = np.array([[0.1, 0.2, 0.3], [0.1, np.inf, np.inf],
                      [np.inf, np.inf, np.inf]], np.float32)
    partial, empty = pkg.dropped_counts(dists)
    assert (partial, empty) == (2, 1)
    assert int(np.isinf(dists).sum()) == 5
    return [pkg.dropped_counts(dists), pkg.dropped_counts(dists[:, 0])]


def test_dropped_counts_are_per_query_not_per_cell():
    both(_dropped)


# ------------------------------ multi-tenancy, reordering, admission


def _multi_tenant(pkg):
    pts_b = pkg.core.make_dataset("kitti", 700, seed=8)
    qs_b = pkg.core.make_dataset("kitti", 24, seed=15)
    ia, ib = pkg.build(PTS), pkg.build(pts_b)
    server = pkg.NeighborServer(indexes={"gps": ia, "lidar": ib},
                                cache_size=0)
    ta = server.submit(QS, pkg.KnnSpec(4), index="gps")
    tb = server.submit(qs_b, pkg.KnnSpec(4), index="lidar")
    assert np.array_equal(ta.result().dists,
                          ia.query(QS, pkg.KnnSpec(4)).dists)
    assert np.array_equal(tb.result().dists,
                          ib.query(qs_b, pkg.KnnSpec(4)).dists)
    s = server.stats()
    assert set(s["buckets"]) == {"gps/knn/k=4/l2", "lidar/knn/k=4/l2"}
    assert set(s["indexes"]) == {"gps", "lidar"}
    with pytest.raises(ValueError, match="for index 'lidar'"):
        server.submit(QS, pkg.KnnSpec(3), index="lidar")
    with pytest.raises(KeyError, match="unknown index"):
        server.submit(QS, pkg.KnnSpec(3), index="nope")
    with pytest.raises(ValueError, match="pass submit"):
        server.submit(QS, pkg.KnnSpec(3))
    solo = pkg.NeighborServer(indexes={"only": ia}, cache_size=0)
    one = solo.submit(QS, pkg.KnnSpec(3)).result()
    assert one.dists.shape == (48, 3)
    return [served(ta.result()), served(tb.result()), served(one), meters(s)]


def test_server_multi_tenant_routes_by_index_name():
    both(_multi_tenant)


def _lifecycle(pkg):
    ia = pkg.build(PTS)
    server = pkg.NeighborServer(ia, cache_size=0)
    server.add_index("extra", pkg.build(PTS))
    with pytest.raises(ValueError, match="already registered"):
        server.add_index("extra", ia)
    t = server.submit(QS[:4], pkg.KnnSpec(3), index="extra")
    with pytest.raises(ValueError, match="pending"):
        server.remove_index("extra")
    t.result()
    server.remove_index("extra")
    with pytest.raises(KeyError):
        server.remove_index("extra")
    assert server.index is ia
    last = server.submit(QS[:2], pkg.KnnSpec(2)).result()
    assert last.dists.shape == (2, 2)
    return [served(t.result()), served(last), meters(server.stats())]


def test_server_add_remove_index_lifecycle():
    both(_lifecycle)


def _tenant_caches(pkg):
    server = pkg.NeighborServer(indexes={"a": pkg.build(PTS),
                                         "b": pkg.build(PTS)})
    server.submit(QS[:4], pkg.KnnSpec(3), index="a").result()
    hit = server.submit(QS[:4], pkg.KnnSpec(3), index="a").result()
    assert hit.timings["plan"] == "cache"
    miss = server.submit(QS[:4], pkg.KnnSpec(3), index="b").result()
    assert miss.timings["plan"] != "cache"
    return [served(hit), served(miss), meters(server.stats())]


def test_server_tenants_do_not_share_cache_entries():
    both(_tenant_caches)


def _morton(pkg):
    index = pkg.build(PTS)
    direct = index.query(QS, pkg.KnnSpec(5))
    perm = np.argsort(np.tile([0, 1], len(QS) // 2 + 1)[: len(QS)],
                      kind="stable")
    scrambled = QS[perm]
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0)
    res = server.submit(scrambled, pkg.KnnSpec(5)).result()
    assert np.array_equal(res.dists, direct.dists[perm])
    assert np.array_equal(res.idxs, direct.idxs[perm])
    s = server.stats()
    assert s["reordered_batches"] == 1
    assert s["buckets"]["default/knn/k=5/l2"]["reordered_batches"] == 1
    off = pkg.NeighborServer(pkg.build(PTS), cache_size=0, reorder="none")
    res2 = off.submit(scrambled, pkg.KnnSpec(5)).result()
    assert np.array_equal(res2.dists, res.dists)
    assert off.stats()["reordered_batches"] == 0
    with pytest.raises(ValueError, match="reorder"):
        pkg.NeighborServer(index, reorder="hilbert")
    return [served(res), served(res2), meters(s)]


def test_server_morton_reorder_preserves_results_and_counts():
    both(_morton)


def _admission(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0, max_queue=10)
    ok = server.submit(QS[:8], pkg.KnnSpec(3))
    shed = server.submit(QS[:8], pkg.KnnSpec(3))
    assert shed.done()
    with pytest.raises(pkg.AdmissionError, match="queue full"):
        shed.result()
    s = server.stats()
    assert s["rejected"] == 1
    assert s["buckets"]["default/knn/k=3/l2"]["rejected"] == 1
    assert s["pending_rows"] == 8
    assert s["buckets"]["default/knn/k=3/l2"]["requests"] == 1
    assert np.array_equal(
        ok.result().dists,
        pkg.build(PTS).query(QS[:8], pkg.KnnSpec(3)).dists)
    again = server.submit(QS[:8], pkg.KnnSpec(3)).result()
    assert again.dists.shape == (8, 3)
    assert server.stats()["rejected"] == 1
    return [served(ok.result()), served(again), meters(server.stats())]


def test_server_admission_control_rejects_past_max_queue():
    both(_admission)


def _admission_cached(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), max_queue=8,
                                cache_size=1024)
    primed = server.submit(QS[:4], pkg.KnnSpec(3))
    primed.result()
    blocker = server.submit(QS[8:16], pkg.KnnSpec(3))
    cached = server.submit(QS[:4], pkg.KnnSpec(3))
    assert cached.done()
    res = cached.result()
    assert res.timings["plan"] == "cache"
    assert np.array_equal(res.dists, primed.result().dists)
    shed = server.submit(QS[16:20], pkg.KnnSpec(3))
    with pytest.raises(pkg.AdmissionError, match="queue full"):
        shed.result()
    assert server.stats()["rejected"] == 1
    blocker.result()
    return [served(res), served(blocker.result()), meters(server.stats())]


def test_admission_control_serves_cached_rows_when_queue_full():
    both(_admission_cached)


def _remove_in_flight(pkg):
    idx = pkg.build(PTS)
    server = pkg.NeighborServer(indexes={"x": idx}, cache_size=0)
    orig = idx.execute_knn
    seen = {}

    def knn_and_try_remove(q, spec, metric, ctx=None):
        with pytest.raises(ValueError, match="pending"):
            server.remove_index("x")
        seen["guarded"] = True
        return orig(q, spec, metric, ctx=ctx)

    idx.execute_knn = knn_and_try_remove
    res = server.submit(QS[:4], pkg.KnnSpec(3), index="x").result()
    assert seen["guarded"] and res.dists.shape == (4, 3)
    server.remove_index("x")
    return served(res)


def test_remove_index_refuses_while_batch_is_in_flight():
    both(_remove_in_flight)


def _admission_in_flight(pkg):
    idx = pkg.build(PTS)
    server = pkg.NeighborServer(idx, cache_size=0, max_queue=8)
    orig = idx.execute_knn
    seen = {}

    def knn_and_probe(q, spec, metric, ctx=None):
        shed = server.submit(QS[8:12], pkg.KnnSpec(3))
        assert shed.done()
        with pytest.raises(pkg.AdmissionError, match="8 rows pending"):
            shed.result()
        seen["probed"] = True
        return orig(q, spec, metric, ctx=ctx)

    idx.execute_knn = knn_and_probe
    res = server.submit(QS[:8], pkg.KnnSpec(3)).result()
    idx.execute_knn = orig
    assert seen["probed"] and res.dists.shape == (8, 3)
    assert server.stats()["rejected"] == 1
    after = server.submit(QS[:4], pkg.KnnSpec(3)).result()
    assert after.dists.shape == (4, 3)
    return [served(res), served(after), meters(server.stats())]


def test_admission_control_counts_in_flight_rows_as_pending():
    both(_admission_in_flight)


def _ambiguous(pkg):
    server = pkg.NeighborServer(indexes={"a": pkg.build(PTS),
                                         "b": pkg.build(PTS)})
    with pytest.raises(ValueError, match="several indexes"):
        server.index
    with pytest.raises(ValueError, match="several indexes"):
        hasattr(server, "index")
    return server.indexes()


def test_multi_tenant_index_property_is_loud_not_attributeerror():
    both(_ambiguous)


def _open_loop_shed(pkg):
    server = pkg.NeighborServer(pkg.build(PTS), cache_size=0, max_queue=0)
    rng = np.random.default_rng(0)
    results, wall, lat = pkg.server.poisson_open_loop(
        server, QS[:8], pkg.KnnSpec(3), rate=1e6, rng=rng)
    assert results == [] and lat.size == 0
    assert server.stats()["rejected"] == 8
    assert not server.stats()["worker_running"]
    return meters(server.stats())


def test_poisson_open_loop_survives_shed_requests():
    both(_open_loop_shed)


def _open_loop_served(pkg):
    """Every request of a Poisson drive is served, each equal to the
    direct query of its row (the launcher's open loop)."""
    index = pkg.build(PTS)
    server = pkg.NeighborServer(index, max_batch=16)
    results, wall, lat = pkg.server.poisson_open_loop(
        server, QS, pkg.KnnSpec(4), rate=5000.0,
        rng=np.random.default_rng(3))
    assert len(results) == len(QS) and lat.shape == (len(QS),)
    direct = index.query(QS, pkg.KnnSpec(4))
    assert np.array_equal(np.vstack([r.dists for r in results]),
                          direct.dists)
    assert np.array_equal(np.vstack([r.idxs for r in results]), direct.idxs)
    s = server.stats()
    assert s["submitted"] == s["served"] == len(QS) and s["rejected"] == 0
    return served(direct)


def test_poisson_open_loop_serves_every_request():
    both(_open_loop_served)
