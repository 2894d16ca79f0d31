"""kNN-graph construction on a resident index (port of
``repro.workloads.graph``).

``build_knn_graph(index, k)`` turns the paper's benchmark setting — the
dataset queries itself — into a first-class artifact: a CSR adjacency
(``indptr``/``indices``/``dists``) over the cloud, built through the
planner's ``AllPairsSpec`` self-query route (device-buffer reuse,
chunked million-row batches).

Determinism: every backend is exact with the (dist, id) lexicographic
tie-break, so the per-row neighbor *sets* are the unique k-NN answer;
this module re-sorts edges into one canonical order — by (row, dist,
col) — so the CSR arrays are ``np.array_equal`` across brute /
fixed_radius / trueknn / sharded (host or placed) whatever each engine's
internal row order was.
Distances are bitwise symmetric (IEEE ``(a-b)**2 == (b-a)**2`` per
coordinate, same summation order), so symmetrization never invents a
second float value for the same edge.

Stability under mutation: the build stamps ``index.generation`` before
and after the self-query and retries when a write slid in between, so a
``KnnGraph`` is always a snapshot of ONE logical generation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..api.query import AllPairsSpec

__all__ = ["KnnGraph", "build_knn_graph", "symmetrize_edges",
           "snapshot_ids", "ids_to_rows"]

_SYMMETRIZE_MODES = ("union", "mutual", "none")


@dataclasses.dataclass
class KnnGraph:
    """CSR adjacency over the resident cloud.

    Row ``i``'s neighbors live at ``indices[indptr[i]:indptr[i+1]]`` with
    matching ``dists``, sorted by (dist, col) ascending.  ``generation``
    is the index generation the graph snapshotted (mutable backends bump
    it on every write; immutable indexes stay at 0).
    """

    indptr: np.ndarray  # (N+1,) int64
    indices: np.ndarray  # (nnz,) int32
    dists: np.ndarray  # (nnz,) float32
    n: int
    k: int
    symmetrize: str
    generation: int
    backend: str = ""
    metric: str = "l2"
    n_tests: int = 0
    #: stable dataset id of each row (mutable backends only; None means
    #: row position == dataset id, the immutable convention)
    ids: Optional[np.ndarray] = None

    @property
    def n_edges(self) -> int:
        return int(self.indptr[-1])

    @property
    def counts(self) -> np.ndarray:
        """(N,) out-degree per row."""
        return np.diff(self.indptr)

    def neighbors(self, i: int):
        """(cols, dists) of row ``i``, nearest-first."""
        sl = slice(int(self.indptr[i]), int(self.indptr[i + 1]))
        return self.indices[sl], self.dists[sl]


def snapshot_ids(index) -> Optional[np.ndarray]:
    """Live stable ids in row order, or None when row position == id
    (every immutable backend).  Mutable composites expose ``snapshot()``;
    its id list is ascending, one per live row."""
    snap = getattr(index, "snapshot", None)
    if snap is None:
        return None
    return np.asarray(snap()[1], np.int64)


def ids_to_rows(idxs, ids: Optional[np.ndarray], sentinel: int, n: int):
    """Map dataset ids back to row positions (identity when ``ids`` is
    None).  ``sentinel`` bounds the id space (mutable stable ids outlive
    deletion, so ids can exceed the live count)."""
    idxs = np.asarray(idxs, np.int64)
    if ids is None:
        return idxs
    lut = np.full((int(sentinel) + 1,), -1, np.int64)
    lut[ids] = np.arange(n, dtype=np.int64)
    return lut[idxs]


def _canonical_csr(rows, cols, dd, n: int):
    """Dedupe (row, col) pairs and sort every row by (dist, col): ONE
    canonical edge order whatever order the engines produced."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    dd = np.asarray(dd, np.float32)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(key.shape, bool)
    keep[1:] = key[1:] != key[:-1]
    rows, cols, dd = rows[order][keep], cols[order][keep], dd[order][keep]
    order = np.lexsort((cols, dd, rows))
    rows, cols, dd = rows[order], cols[order], dd[order]
    indptr = np.zeros((n + 1,), np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols.astype(np.int32), dd


def symmetrize_edges(rows, cols, dd, n: int, mode: str):
    """Apply a symmetrization mode to a directed edge list; returns the
    canonical CSR triple (see :func:`_canonical_csr`).

    * ``"none"``   — the directed k-NN edges as queried.
    * ``"union"``  — (i, j) present iff i→j OR j→i (the usual undirected
      kNN graph; every row gains the reverse edges).
    * ``"mutual"`` — (i, j) present iff i→j AND j→i (the mutual-kNN
      graph density-based methods favor).
    """
    if mode not in _SYMMETRIZE_MODES:
        raise ValueError(
            f"symmetrize must be one of {_SYMMETRIZE_MODES}, got {mode!r}"
        )
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    dd = np.asarray(dd, np.float32)
    if mode == "union":
        rows, cols, dd = (
            np.concatenate([rows, cols]),
            np.concatenate([cols, rows]),
            np.concatenate([dd, dd]),
        )
    elif mode == "mutual":
        key = rows * n + cols
        rkey = cols * n + rows
        keep = np.isin(key, rkey)
        rows, cols, dd = rows[keep], cols[keep], dd[keep]
    return _canonical_csr(rows, cols, dd, n)


def build_knn_graph(
    index,
    k: int,
    *,
    symmetrize: str = "union",
    metric: str = "l2",
    chunk_rows=None,
    max_retries: int = 8,
) -> KnnGraph:
    """Build the k-NN graph of ``index``'s resident cloud.

    Runs ``AllPairsSpec(k)`` (the planner's self-query route), converts
    the dense (N, k) answer to canonical CSR, and applies ``symmetrize``.
    Generation-stamped: if the index mutated while the self-query ran
    (mutable backend, concurrent writers), the build retries against the
    new snapshot up to ``max_retries`` times.
    """
    if symmetrize not in _SYMMETRIZE_MODES:
        raise ValueError(
            f"symmetrize must be one of {_SYMMETRIZE_MODES}, got "
            f"{symmetrize!r}"
        )
    spec = AllPairsSpec(int(k), chunk_rows=chunk_rows)
    for _ in range(max(1, int(max_retries))):
        gen = int(getattr(index, "generation", 0) or 0)
        n = index.n_points
        ids = snapshot_ids(index)
        res = index.query(None, spec, metric=metric)
        if int(getattr(index, "generation", 0) or 0) == gen:
            break
    else:
        raise RuntimeError(
            f"index mutated through {max_retries} consecutive graph "
            "builds; quiesce writers or raise max_retries"
        )
    d = np.asarray(res.dists)
    ix = np.asarray(res.idxs)
    valid = np.isfinite(d)  # inf/sentinel pads: rows with < k real neighbors
    rows = np.repeat(np.arange(n, dtype=np.int64), d.shape[1])[valid.ravel()]
    cols = ids_to_rows(
        ix[valid], ids, int(getattr(index, "sentinel", n)), n
    )
    indptr, indices, dists = symmetrize_edges(
        rows, cols, d[valid], n, symmetrize
    )
    return KnnGraph(
        indptr=indptr,
        indices=indices,
        dists=dists,
        n=n,
        k=int(k),
        symmetrize=symmetrize,
        generation=gen,
        backend=index.backend_name,
        metric=res.metric,
        n_tests=int(res.n_tests),
        ids=ids,
    )
