"""Quickstart: build an index once, plan every query through a spec (the
port's twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 20000] \
        [--device cuda]

``build_index`` makes the paper's workload shape explicit: the structure is
resident (on the card by default), queries stream through it, and search
state (cached radius-lattice grids, warm-start radius) amortizes across
calls.  The question is a typed value:

    KnnSpec(k)            unbounded k nearest (the paper's TrueKNN)
    RangeSpec(r)          everything within r  -> ragged RangeResult (CSR)
    HybridSpec(k, r)      k nearest, but never beyond r

and the metric is a keyword: ``index.query(q, spec, metric="cosine")``.
"""

import argparse

import numpy as np


def main(argv=None):
    from repro_torch import (HybridSpec, KnnSpec, NeighborServer, RangeSpec,
                             available_backends, build_index, make_dataset,
                             make_mutable)
    from repro_torch.api import available_metrics
    from repro_torch.workloads import build_knn_graph, dbscan

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    checks = {}

    pts = make_dataset("porto", args.n, seed=0)  # heavy-tailed 2D GPS-like
    index = build_index(pts, backend="trueknn", device=dev)  # now resident

    # -- kNN: the dataset queries itself (the paper's benchmark setting) ----
    res = index.query(None, KnnSpec(k=5))
    print(f"found 5-NN for all {len(pts)} points in {res.n_rounds} rounds")
    print(f"start radius {res.start_radius:.2e} -> final "
          f"{res.final_radius:.2e}")
    print(f"candidate distance tests: {res.n_tests:,}")

    # -- the exact oracle agrees --------------------------------------------
    oracle = build_index(pts, backend="brute", device=dev)
    bres = oracle.query(None, KnnSpec(k=5))
    print(f"brute force would test:   {bres.n_tests:,} "
          f"({bres.n_tests/res.n_tests:.0f}x more)")
    ok = np.allclose(np.sort(res.dists, 1), np.sort(bres.dists, 1),
                     rtol=1e-4, atol=1e-7)
    checks["exact_vs_brute"] = bool(ok)
    print(f"exact vs brute force: {ok}")

    # -- range search: ragged CSR answer on the same warm structure ---------
    r = float(np.median(res.dists[:, -1]))  # a radius most queries can fill
    rng = index.query(pts[:512], RangeSpec(radius=r))
    print(
        f"range(r={r:.3g}): {rng.counts.sum():,} neighbors over 512 queries "
        f"(row sizes {rng.counts.min()}..{rng.counts.max()}, "
        f"CSR nnz={len(rng.idxs):,}, plan={rng.timings['plan']})"
    )

    # -- hybrid: top-k but never beyond the radius cap ----------------------
    hyb = index.query(pts[:512], HybridSpec(k=5, radius=r / 4))
    dropped = int(np.isinf(hyb.dists).sum())
    print(f"hybrid(k=5, cap={r/4:.3g}): {dropped} of {512*5} slots beyond "
          f"the cap")

    # -- pluggable metrics: same index, same specs, different distance ------
    cos = index.query(pts[:256], KnnSpec(k=5), metric="cosine")
    print(
        f"cosine 5-NN via {cos.timings.get('plan', 'native')} plan "
        f"(grid machinery runs on the normalized companion cloud)"
    )

    # -- warm serving: new batches hit cached grids -------------------------
    qs = pts[:256] + np.float32(0.001)
    res2 = index.query(qs, KnnSpec(k=5))
    checks["warm_grid_builds"] = res2.timings["grid_builds"]
    checks["warm_start"] = res2.timings["start_radius_source"]
    print(
        f"warm batch: {res2.n_rounds} rounds, "
        f"{res2.timings['grid_cache_hits']} cached grids reused, "
        f"{res2.timings['grid_builds']} built "
        f"(start radius {res2.timings['start_radius_source']})"
    )

    # -- fused execution: the round loop waits on the device once ----------
    # trueknn launches every scheduled round of its expand-until-k search
    # and syncs once (plan tag fused/rounds<=N; fused=False keeps the
    # per-round host loop as the oracle).
    before = index.stats()["dispatches"]
    fres = index.query(qs, KnnSpec(k=5))
    print(
        f"fused: {fres.n_rounds} rounds in "
        f"{index.stats()['dispatches'] - before} dispatch "
        f"(plan={fres.timings['plan']}, "
        f"resolved_radius_p50={fres.timings['resolved_radius_p50']:.3g})"
    )

    # -- prepared plans: plan once, execute many ----------------------------
    plan = index.prepare(KnnSpec(k=5))
    plan(qs)
    plan(qs + np.float32(0.002))
    print(
        f"prepared plan: tag={plan.explain()['tag']} "
        f"executable-cache {plan.cache_stats()['hits']} hits / "
        f"{plan.cache_stats()['misses']} misses over "
        f"{plan.cache_stats()['executions']} executions"
    )

    # -- mutation: insert/delete on the resident index ----------------------
    # make_mutable adopts the already-built index as the base of an LSM
    # composite (no rebuild): writes land in brute delta shards, deletes
    # become tombstones, and answers stay bit-identical to a monolithic
    # rebuild over the live rows.  compact() folds the log back into the base.
    mindex = make_mutable(index)
    new_ids = mindex.insert(pts[:64] + np.float32(0.01))  # minted stable ids
    mindex.delete(new_ids[:8])
    mres = mindex.query(qs, KnnSpec(k=5))
    st = mindex.stats()
    print(
        f"mutable: +{len(new_ids)} rows, -8 (delta_rows={st['delta_rows']}, "
        f"tombstones={st['tombstones']}), plan={mres.timings['plan']}"
    )
    mindex.compact()
    st = mindex.stats()
    print(
        f"compacted: base_rows={st['base_rows']} delta_rows="
        f"{st['delta_rows']} tombstones={st['tombstones']} (generation "
        f"{mindex.generation})"
    )

    # -- device placement: one fused dispatch per sharded round -------------
    # placement="devices" pins each shard's point block to a mesh position
    # (by default every card; the CPU is one position) and runs every
    # shared-cut round as one dispatch instead of S sequential child
    # queries — bit-identical answers, plan tag /placed=<dispatches>.
    placed = build_index(pts, backend="sharded", n_shards="auto",
                         placement="devices", device=dev)
    pres = placed.query(qs, KnnSpec(k=5))
    ps = placed.stats()["placement"]
    print(
        f"placed: {placed.n_shards} shards in {ps['slots']} slots on "
        f"{ps['devices']} device(s), plan={pres.timings['plan']}, "
        f"occupancy={ps['device_occupancy']}"
    )
    same = bool(np.array_equal(pres.dists,
                               index.query(qs, KnnSpec(k=5)).dists))
    checks["placed_equals_monolith"] = same
    print(f"placed == monolith: {same}")

    # -- graph workloads: kNN graph + DBSCAN on the fabric ------------------
    # AllPairsSpec is "the dataset queries itself" as a first-class spec;
    # the workloads package turns it into artifacts, the same CSR arrays
    # and labels from every backend — shown on a 4k slice, the brute
    # reference against the device-placed fabric.
    wpts = pts[:4_000]
    ref_idx = build_index(wpts, backend="brute", device=dev)
    g = build_knn_graph(ref_idx, k=5, symmetrize="union")
    deg = g.counts
    print(
        f"kNN graph: {g.n} nodes, {g.n_edges} undirected edges "
        f"(degree min {int(deg.min())} / max {int(deg.max())}), "
        f"backend={g.backend}"
    )
    wplaced = build_index(wpts, backend="sharded", n_shards="auto",
                          placement="devices", device=dev)
    g2 = build_knn_graph(wplaced, k=5, symmetrize="union")
    same = bool(np.array_equal(g.indices, g2.indices))
    checks["graph_identical"] = same
    print(f"graph identical from placed fabric: {same}")

    eps = float(np.median(g.dists)) * 1.5
    clus = dbscan(wplaced, eps, min_pts=6)
    print(
        f"DBSCAN(eps={eps:.4f}, min_pts=6): {clus.n_clusters} clusters, "
        f"{int(clus.core.sum())} core points, {clus.n_noise} noise"
    )

    # the same workloads as server tickets (ordered against tenant writes)
    wserver = NeighborServer(wplaced)
    wt = wserver.submit_cluster(eps, 6)
    same = bool(np.array_equal(wt.result().labels, clus.labels))
    checks["served_cluster_equals_direct"] = same
    print(f"served cluster ticket == direct: {same}; "
          f"meter {wserver.stats()['workloads']['default']}")

    print(f"registered backends: {available_backends()}")
    print(f"registered metrics:  {available_metrics()}")
    return checks


if __name__ == "__main__":
    main()
