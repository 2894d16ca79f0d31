"""The port's graph workloads (``repro_torch.workloads``) against the JAX
package's: union-find properties, ``build_knn_graph`` in its three
symmetrize modes and ``dbscan`` labels and core mask, ``np.array_equal`` to
``repro.workloads`` on the same inputs and backend, and identical across
the brute, fixed_radius and trueknn backends (the sharded fabric, host and
placed: ``test_torch_workloads_sharded.py``)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as jax_api
import repro.workloads as jax_workloads
from repro_torch import build_index, make_dataset
from repro_torch.api import get_metric
from repro_torch.workloads import (
    DbscanResult,
    build_knn_graph,
    connected_components,
    dbscan,
    symmetrize_edges,
    uf_build,
    uf_roots,
    uf_union,
)

torch.set_num_threads(1)

BACKENDS = ["brute", "fixed_radius", "trueknn"]
PTS = make_dataset("kitti", 300, seed=3)
K = 5

# four well-separated blobs along the space diagonal
_rng = np.random.default_rng(0)
BLOBS = np.concatenate([
    np.full(3, 100.0 * i, np.float32)
    + _rng.normal(scale=1.0, size=(64, 3)).astype(np.float32)
    for i in range(4)
])


def _eps(pts, metric, q=0.3):
    """A DBSCAN radius at the q-quantile of 4th-NN distances."""
    d = get_metric(metric).pairwise(pts, pts)
    np.fill_diagonal(d, np.inf)
    return float(np.quantile(np.sort(d, 1)[:, 3], q))


def _kth(pts, k):
    """The largest k-th-NN distance (a fixed_radius kNN's cfg radius that
    fills every row)."""
    d = get_metric("l2").pairwise(pts, pts)
    np.fill_diagonal(d, np.inf)
    return float(np.sort(d, 1)[:, k - 1].max()) * 1.001


def _pair(backend, pts=PTS, **cfg):
    return (build_index(pts, backend=backend, device="cpu", **cfg),
            jax_api.build_index(pts, backend=backend, **cfg))


def _same_graph(got, want, *, same_work=True):
    for key in ("indptr", "indices", "dists"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert (got.n, got.k, got.symmetrize, got.generation, got.metric) == (
        want.n, want.k, want.symmetrize, want.generation, want.metric)
    if same_work:
        assert got.n_tests == want.n_tests


def _same_clusters(got, want):
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.core, want.core)
    assert (got.n_clusters, got.n_noise, got.n_tests) == (
        want.n_clusters, want.n_noise, want.n_tests)


# ------------------------------------------------------ union-find algebra


def _random_edges(rng, n, m):
    return rng.integers(0, n, size=(m, 2))


@settings(max_examples=25)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 40))
def test_unionfind_idempotent_and_commutative(seed, n):
    rng = np.random.default_rng(seed)
    edges = _random_edges(rng, n, 3 * n)
    base = connected_components(n, edges)
    assert np.array_equal(base, connected_components(
        n, np.concatenate([edges, edges])))
    for _ in range(3):
        perm = rng.permutation(len(edges))
        assert np.array_equal(base, connected_components(n, edges[perm]))
    assert np.array_equal(base, jax_workloads.connected_components(n, edges))


@settings(max_examples=25)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 40))
def test_unionfind_min_label_roots(seed, n):
    """Each node's root is the minimum member of its component (checked
    against an independent BFS component sweep)."""
    rng = np.random.default_rng(seed)
    edges = _random_edges(rng, n, 2 * n)
    roots = connected_components(n, edges)
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(int(b))
        adj[b].append(int(a))
    seen = np.zeros(n, bool)
    for s in range(n):
        if seen[s]:
            continue
        comp, stack = [], [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        assert (roots[comp] == min(comp)).all()


def test_unionfind_union_returns_min_root():
    parent = uf_build(5)
    assert uf_union(parent, 3, 4) == 3
    assert uf_union(parent, 4, 1) == 1
    assert uf_union(parent, 1, 3) == 1  # already merged: root unchanged
    assert np.array_equal(uf_roots(parent), [0, 1, 2, 1, 1])


# ------------------------------------------------------------ kNN graphs


@pytest.mark.parametrize("mode", ["none", "union", "mutual"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_knn_graph_matches_reference(backend, mode):
    cfg = {"radius": _kth(PTS, K)} if backend == "fixed_radius" else {}
    port, ref = _pair(backend, **cfg)
    got = build_knn_graph(port, K, symmetrize=mode)
    _same_graph(got, jax_workloads.build_knn_graph(ref, K, symmetrize=mode))
    assert got.backend == backend and got.ids is None
    if mode == "none":
        assert np.array_equal(got.counts, np.full(len(PTS), K))


def test_knn_graph_chunked_and_cosine():
    port, ref = _pair("trueknn")
    whole = build_knn_graph(port, K)
    _same_graph(whole, jax_workloads.build_knn_graph(ref, K))
    chunked = build_knn_graph(port, K, chunk_rows=128)
    _same_graph(chunked, whole, same_work=False)  # other batches
    _same_graph(chunked, jax_workloads.build_knn_graph(ref, K, chunk_rows=128))
    _same_graph(build_knn_graph(port, K, metric="cosine"),
                jax_workloads.build_knn_graph(ref, K, metric="cosine"))


def test_symmetrize_edges_rejects_unknown_mode():
    with pytest.raises(ValueError):
        symmetrize_edges([0], [1], [1.0], 2, "both")
    with pytest.raises(ValueError):
        build_knn_graph(build_index(PTS, backend="brute", device="cpu"), 3,
                        symmetrize="both")


# ---------------------------------------------------------------- DBSCAN


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_dbscan_matches_reference(backend, metric):
    eps = _eps(PTS, metric)
    port, ref = _pair(backend)
    got = dbscan(port, eps, 4, metric=metric)
    _same_clusters(got, jax_workloads.dbscan(ref, eps, 4, metric=metric))
    assert got.n_noise > 0 and got.n_clusters > 1
    assert isinstance(got, DbscanResult) and got.backend == backend


def test_identity_across_the_port_backends():
    eps = 2.5  # blobs of unit spread, 173 apart
    graphs, clusters = {}, {}
    for backend in BACKENDS:
        cfg = ({"radius": _kth(BLOBS, 6)} if backend == "fixed_radius"
               else {})
        index = build_index(BLOBS, backend=backend, device="cpu", **cfg)
        graphs[backend] = build_knn_graph(index, 6)
        clusters[backend] = dbscan(index, eps, 5, chunk_rows=100)
    assert clusters["brute"].n_clusters == 4  # the four blobs
    for backend in BACKENDS[1:]:
        _same_graph(graphs[backend], graphs["brute"], same_work=False)
        for key in ("labels", "core"):
            assert np.array_equal(getattr(clusters[backend], key),
                                  getattr(clusters["brute"], key)), key


def test_dbscan_edge_cases():
    """The inclusive ``d == eps`` boundary, ``min_pts = 1``, and the
    parameter check, as in the reference."""
    pts = np.float32([[0, 0], [3, 0], [6, 0], [100, 100]])
    idx = build_index(pts, backend="fixed_radius", device="cpu")
    res = dbscan(idx, 3.0, 2)  # d(0,1) == d(1,2) == eps exactly
    assert res.core.tolist() == [True, True, True, False]
    assert res.labels.tolist() == [0, 0, 0, -1]
    res = dbscan(idx, 2.9999, 2)
    assert res.n_clusters == 0 and res.n_noise == 4
    res = dbscan(build_index(PTS[:60], backend="trueknn", device="cpu"),
                 1e-9, 1)
    assert res.core.all() and res.n_clusters == 60
    with pytest.raises(ValueError):
        dbscan(idx, 1.0, 0)
