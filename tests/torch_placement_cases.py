"""Shared cases of ``tests/test_torch_placement.py``.

``run_all`` builds the same placed sharded indexes and runs the same
query sequence through either package: the JAX reference (in a
subprocess whose device count is forced to P) or the port (on a P-position
CPU ``DeviceMesh``).  It returns every answer, plan tag, dispatch count,
round record and counter under a key whose first part names the test
group that compares it.  Inputs come from numpy seeds and the packages'
own (equal) ``make_dataset``.
"""

import numpy as np

METRICS = ("l2", "l1", "linf", "cosine")
GROUPS = ("matrix-l2", "matrix-l1", "matrix-linf", "matrix-cosine", "self",
          "kitti", "escalate", "auto", "d12", "d64", "rebalance", "plan",
          "empty", "stats")


def inputs(make_dataset):
    """The porto cloud and queries of the reference's placement tests
    (700 points, 5 shards; two far-out rows answer empty)."""
    pts = make_dataset("porto", 700, seed=4)
    qs = np.concatenate([make_dataset("porto", 28, seed=11),
                         np.float32([[40.0, 40.0], [-35.0, 20.0]])])
    return pts, qs


def wide(d, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(12, d)).astype(np.float32))


def pick_radius(get_metric, metric, qs, pts, col=4, pct=55.0):
    dist = get_metric(metric).pairwise(qs, pts)
    return float(np.percentile(np.sort(dist, 1)[:, col], pct))


def record(out, tag, res):
    out[f"{tag}/plan"] = res.timings.get("plan")
    out[f"{tag}/fused_dispatches"] = res.timings.get("fused_dispatches")
    out[f"{tag}/n_tests"] = int(res.n_tests)
    if hasattr(res, "offsets"):
        for key in ("offsets", "idxs", "dists"):
            out[f"{tag}/{key}"] = np.asarray(getattr(res, key))
        out[f"{tag}/truncated"] = (None if res.truncated is None
                                   else np.asarray(res.truncated))
        return
    for key in ("dists", "idxs"):
        out[f"{tag}/{key}"] = np.asarray(getattr(res, key))
    out[f"{tag}/found"] = (None if res.found is None
                           else np.asarray(res.found))
    out[f"{tag}/rounds"] = [
        (r.round_idx, r.radius, r.n_queries, r.n_resolved, r.n_tests)
        for r in (res.rounds or [])
    ]


def _stats(out, tag, index):
    s = index.stats()
    for key in ("batches", "queries_served", "shard_visits",
                "shard_visits_pruned", "shard_rounds", "shard_searches",
                "child_dispatches", "fused_dispatches", "rebalances",
                "self_local_rows", "self_boundary_rows", "prune_rate",
                "warm_seed", "n_shards", "shard_sizes"):
        out[f"stats/{tag}/{key}"] = s[key]
    out[f"stats/{tag}/placement"] = s["placement"]


def run_all(api, make_dataset, **cfg):
    """Drive every case; ``api`` has ``build_index``, the specs and
    ``get_metric``; ``cfg`` goes to every ``build_index`` (the port's
    mesh and device)."""
    knn, hyb, rng = api.KnnSpec, api.HybridSpec, api.RangeSpec
    out = {}

    def placed(points, **kw):
        return api.build_index(points, backend="sharded",
                               placement="devices", **kw, **cfg)

    pts, qs = inputs(make_dataset)
    index = placed(pts, n_shards=5)  # non-pow2 arity on purpose
    out["stats/projected"] = index.stats()["placement"]
    for metric in METRICS:
        r = pick_radius(api.get_metric, metric, qs, pts)
        for name, spec in (("knn", knn(5)), ("hybrid", hyb(5, r)),
                           ("range_capped", rng(r, max_neighbors=3)),
                           ("range", rng(r))):
            record(out, f"matrix-{metric}/{name}",
                   index.query(qs, spec, metric=metric))
    r = pick_radius(api.get_metric, "l2", qs, pts)
    for name, spec in (("knn", knn(4)), ("hybrid", hyb(4, r)),
                       ("range", rng(r, max_neighbors=5))):
        record(out, f"self/{name}", index.query(None, spec))
    # balls of more than 32 rows in a shard: the range's escalated second
    # dispatch, at min(next_pow2(need), B)
    for metric in ("l2", "l1"):
        big = pick_radius(api.get_metric, metric, qs, pts, col=60, pct=90.0)
        record(out, f"escalate/{metric}",
               index.query(qs, rng(big), metric=metric))
    empty = np.empty((0, 2), np.float32)
    record(out, "empty/knn", index.query(empty, knn(3)))
    record(out, "empty/range", index.query(empty, rng(0.5)))
    plan = index.prepare(hyb(4, r))
    plan(qs)
    first = plan.cache_stats()
    plan(qs + np.float32(0.001))  # same shape, other values
    out["plan/cache_stats"] = (first, plan.cache_stats())
    out["plan/explain_placement"] = plan.explain()["props"]["placement"]
    # rebalance: split the hottest shard into a free slot (P = 1 has none)
    before = index.query(qs, knn(4))
    out["rebalance/moved"] = bool(index.rebalance())
    record(out, "rebalance/before", before)
    record(out, "rebalance/after", index.query(qs, knn(4)))
    record(out, "rebalance/range_after",
           index.query(qs, rng(r, max_neighbors=3)))
    _stats(out, "porto", index)

    none_pts = np.empty((0, 2), np.float32)
    record(out, "empty/n0", placed(none_pts).query(qs[:3], knn(2)))

    kpts = make_dataset("kitti", 800, seed=3)
    kqs = make_dataset("kitti", 24, seed=5)
    kidx = placed(kpts, n_shards=4)
    for metric in ("l2", "l1", "linf"):
        kr = pick_radius(api.get_metric, metric, kqs, kpts)
        for name, spec in (("knn", knn(6)), ("hybrid", hyb(6, kr)),
                           ("range", rng(kr))):
            record(out, f"kitti/{metric}/{name}",
                   kidx.query(kqs, spec, metric=metric))
    _stats(out, "kitti", kidx)

    auto = placed(pts, n_shards="auto")
    out["auto/n_shards"] = auto.n_shards
    record(out, "auto/knn", auto.query(qs, knn(3)))

    for d, tag in ((12, "d12"), (64, "d64")):
        wpts, wqs = wide(d, 500, seed=d)
        widx = placed(wpts, n_shards=4)
        wr = pick_radius(api.get_metric, "l2", wqs, wpts)
        for name, spec in (("knn", knn(5)), ("hybrid", hyb(5, wr)),
                           ("range", rng(wr))):
            record(out, f"{tag}/{name}", widx.query(wqs, spec))
    return out
