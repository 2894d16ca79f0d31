"""Exact brute-force kNN engine (port of ``repro.core.brute``).

The exact subroutine of the start-radius sampler (paper Alg. 2), the
exact tail of TrueKNN's multi-round search, and the brute backend's
engine.  The dense top-k runs on the ``pairwise_topk`` engine with an
infinite threshold: the CUDA kernel on the card, its plain version on the
CPU.  Both use the reference's float forms (L2 for d <= 8 as an FMA chain,
L1 as a sequential sum, L∞ as a max) and its tie order (lowest index
first), so answers equal ``repro``'s brute engine bitwise for those forms.
"""

from __future__ import annotations

import math

import torch

from ..kernels.ops import as_f32, l2_normalize, sqrt32, topk_engine

__all__ = ["brute_knn", "brute_knn_engine"]


def _brute_impl(points, queries, query_ids, *, k: int, metric: str,
                row_mask=None, out=None, chunk: int = 0):
    """Exact (d (Q, k), idx (Q, k)) in kernel units (squared for l2) of
    every query — or, with ``row_mask``, of the masked rows only, written
    into ``out``.  ``query_ids`` (Q,) int32 excludes a self index per row
    (N: none)."""
    if out is None:
        out = (
            torch.empty((queries.shape[0], k), dtype=torch.float32,
                        device=points.device),
            torch.empty((queries.shape[0], k), dtype=torch.int32,
                        device=points.device),
        )
    counts = torch.empty((queries.shape[0],), dtype=torch.int32,
                         device=points.device)
    d2, idx, _ = topk_engine(
        queries, query_ids, points, math.inf, k=k, metric=metric,
        row_mask=row_mask, out=(*out, counts), chunk=chunk,
    )
    return d2, idx


def brute_knn_engine(
    points, k, *, queries=None, query_ids=None, chunk: int = 512,
    metric: str = "l2",
):
    """Exact kNN engine.  Returns (dists (Q,k), idxs (Q,k), n_tests), as
    tensors on the device of ``points``.

    ``queries`` None: the dataset queries itself, self-matches excluded.
    ``query_ids`` (with explicit ``queries``): global point index of each
    query for self-exclusion — N (or any out-of-range id) for queries that
    are not dataset members.  ``metric`` picks the distance ("l2", "l1",
    "linf", "cosine"); returned dists are true metric-space values.
    ``chunk`` bounds the query rows of one distance block of the plain
    (CPU) engine; the CUDA kernel streams and needs none.
    """
    dev = points.device if isinstance(points, torch.Tensor) else "cpu"
    pts = as_f32(points, dev)
    if metric == "cosine":
        pts = l2_normalize(pts)  # exact monotone L2 reduction
    elif metric not in ("l2", "l1", "linf"):
        raise ValueError(f"brute_knn_engine: unsupported metric {metric!r}")
    n = pts.shape[0]
    if queries is None:
        q = pts
        qid = torch.arange(n, dtype=torch.int32, device=dev)
        k_cap = n - 1
    else:
        q = as_f32(queries, dev)
        if metric == "cosine":
            q = l2_normalize(q)
        if query_ids is None:
            qid = torch.full((q.shape[0],), n, dtype=torch.int32, device=dev)
        else:
            qid = torch.as_tensor(query_ids, dtype=torch.int32, device=dev)
        k_cap = n  # member queries must request k <= N-1 upstream
    q_total = q.shape[0]
    k_eff = min(int(k), k_cap)
    impl_metric = "l2" if metric == "cosine" else metric
    d2, idx = _brute_impl(
        pts, q, qid.contiguous(), k=k_eff, metric=impl_metric, chunk=chunk
    )
    if k_eff < k:
        pad = (q_total, int(k) - k_eff)
        d2 = torch.cat([d2, d2.new_full(pad, math.inf)], 1)
        idx = torch.cat([idx, idx.new_full(pad, n)], 1)
    n_tests = q_total * n
    if metric == "l2":
        d_out = sqrt32(d2)
    elif metric == "cosine":
        d_out = d2 * 0.5  # squared L2 on normalized rows -> cosine distance
    else:
        d_out = d2  # l1 / linf: already raw metric distances
    return d_out, idx, n_tests


def brute_knn(points, k, *, queries=None, chunk: int = 512, device="cuda"):
    """Deprecated shim: exact kNN via the registry's "brute" backend.

    Returns (dists (Q,k), idxs (Q,k), n_tests) — the historical tuple.
    Prefer ``build_index(points, backend="brute").query(queries, KnnSpec(k))``
    and hold the index across batches.  ``device`` is the index's:
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.
    """
    from ..api import KnnSpec, build_index
    from ..api.query import warn_deprecated_once

    warn_deprecated_once(
        "repro_torch.core.brute.brute_knn",
        "brute_knn() is deprecated; use build_index(points, backend='brute')"
        ".query(queries, KnnSpec(k)) and hold the index across batches",
    )
    res = build_index(points, backend="brute", chunk=chunk,
                      device=device).query(queries, KnnSpec(int(k)))
    return res.dists, res.idxs, res.n_tests
