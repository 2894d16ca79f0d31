"""Shared cases of ``tests/test_torch_workloads_sharded.py``: the graph
workloads over the sharded fabric, run by either package.

``run_all`` builds sharded indexes (``placement="host"``, or
``"devices"`` on whatever mesh the caller's ``cfg`` gives) and returns
every kNN graph (three symmetrize modes), DBSCAN labelling and chunked
``AllPairsSpec`` answer under a key whose first part names its group.
Radii are computed here in float64 numpy, so both packages get the same
numbers.
"""

import numpy as np

GROUPS = ("graph-union", "graph-mutual", "graph-none", "dbscan",
          "all_pairs", "blobs")


def blobs():
    """Four well-separated blobs along the space diagonal (the morton
    cut aligns shard == blob: most self-query rows are shard-local)."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.full(3, 100.0 * i, np.float32)
        + rng.normal(scale=1.0, size=(64, 3)).astype(np.float32)
        for i in range(4)
    ])


def eps_of(pts, col=3, q=0.3):
    d = np.sqrt(((pts[:, None, :].astype(np.float64)
                  - pts[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    return float(np.quantile(np.sort(d, 1)[:, col], q))


def _graph(out, tag, g):
    for key in ("indptr", "indices", "dists"):
        out[f"{tag}/{key}"] = np.asarray(getattr(g, key))
    for key in ("n", "k", "symmetrize", "generation", "metric", "n_tests"):
        out[f"{tag}/{key}"] = getattr(g, key)


def _clusters(out, tag, c):
    out[f"{tag}/labels"] = np.asarray(c.labels)
    out[f"{tag}/core"] = np.asarray(c.core)
    for key in ("n_clusters", "n_noise", "n_tests", "eps", "min_pts"):
        out[f"{tag}/{key}"] = getattr(c, key)


def run_all(api, workloads, make_dataset, placements, **cfg):
    """Drive every case for each placement in ``placements``; ``cfg`` goes
    to every ``build_index`` (the port's device, and its mesh for
    ``"devices"``)."""
    out = {}
    pts = make_dataset("porto", 300, seed=3)
    eps = eps_of(pts)
    bl = blobs()
    for placement in placements:
        kw = dict(cfg)
        if placement == "host":
            kw.pop("mesh", None)

        def index(points, n_shards=4):
            return api.build_index(points, backend="sharded",
                                   n_shards=n_shards, placement=placement,
                                   **kw)

        idx = index(pts)
        for mode in ("union", "mutual", "none"):
            _graph(out, f"graph-{mode}/{placement}",
                   workloads.build_knn_graph(idx, 5, symmetrize=mode))
        _clusters(out, f"dbscan/{placement}", workloads.dbscan(idx, eps, 5))
        _clusters(out, f"dbscan/{placement}/chunked",
                  workloads.dbscan(idx, eps, 5, chunk_rows=70))
        whole = idx.query(None, api.AllPairsSpec(5))
        part = idx.query(None, api.AllPairsSpec(5, chunk_rows=64))
        rng = idx.query(None, api.AllPairsSpec(mode="range", radius=eps,
                                               chunk_rows=100))
        for tag, res in (("whole", whole), ("chunked", part)):
            for key in ("dists", "idxs"):
                out[f"all_pairs/{placement}/{tag}/{key}"] = np.asarray(
                    getattr(res, key))
            out[f"all_pairs/{placement}/{tag}/plan"] = res.timings["plan"]
        for key in ("offsets", "idxs", "dists"):
            out[f"all_pairs/{placement}/range/{key}"] = np.asarray(
                getattr(rng, key))
        bidx = index(bl)
        _graph(out, f"blobs/{placement}/graph",
               workloads.build_knn_graph(bidx, 6, chunk_rows=100))
        _clusters(out, f"blobs/{placement}/dbscan",
                  workloads.dbscan(bidx, 1.0, 5))
        s = bidx.stats()
        for key in ("self_local_rows", "self_boundary_rows", "shard_visits",
                    "shard_visits_pruned"):
            out[f"blobs/{placement}/stats/{key}"] = s[key]
    return out
