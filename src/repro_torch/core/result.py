"""Unified result types shared by every neighbor-search backend.

One dataclass — ``KNNResult`` — is returned by all ``NeighborIndex``
backends (see ``repro_torch.api``), so call sites never branch on which
engine produced an answer.  A host-side copy of ``repro.core.result``: the
same dataclasses and merges, numpy only.  Lives in ``repro_torch.core`` (dependency-free) so
both the core engines and the API layer can import it without cycles.

Since the ShardedIndex fabric, result *merging* is a first-class operation
here too: :func:`merge_knn` folds per-shard ``KNNResult`` parts into one
exact top-k answer (ties broken by ascending index, matching the engines'
stable top-k order, so a sharded answer is bit-identical to the
monolithic one), and :func:`merge_range` folds per-shard CSR
``RangeResult`` parts keeping every row nearest-first and re-deriving the
``truncated`` flags.  Both accumulate ``n_tests`` (and ``rounds`` for
knn) so the paper's work metric survives the split.

Since the mutable-index subsystem, the folds are also *tombstone-aware*:
``merge_knn(..., tombstones=ids)`` / ``merge_range(..., tombstones=ids)``
mask deleted dataset ids out of every part BEFORE the top-k / row-cap
truncation, so a base-index answer that surfaced since-deleted points
still yields the exact k nearest *live* points (callers over-fetch each
part by the tombstone count to guarantee enough live candidates survive
the mask).  The self-exclusion strippers the sharded fabric introduced
(:func:`strip_self_knn` / :func:`strip_self_csr`) live here too, shared
by every composite backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "KNNResult",
    "RangeResult",
    "RoundStats",
    "filter_csr",
    "mask_tombstones",
    "mask_tombstones_csr",
    "merge_knn",
    "merge_range",
    "slice_rows",
    "strip_self_csr",
    "strip_self_knn",
    "topk_merge_rows",
]


@dataclasses.dataclass
class RoundStats:
    """Per-round telemetry of a multi-round (TrueKNN-style) search.

    ``radius`` is the radius *actually searched* that round — recorded
    explicitly rather than reconstructed from the growth factor, so the
    ``stop_radius`` early-break, the extent clamp and the brute-force tail
    (``radius == inf``, ``grid_res == ()``) all report truthfully.
    ``cache_hit`` marks rounds that reused a cached grid instead of
    rebuilding (see the ``trueknn`` backend's grid cache).
    """

    round_idx: int
    radius: float
    n_queries: int
    n_resolved: int
    n_tests: int
    grid_res: tuple
    grid_cap: int
    seconds: float
    cache_hit: bool = False


@dataclasses.dataclass
class KNNResult:
    """Neighbor-search answer, identical across backends.

    Attributes:
      dists:   (Q, k) float32 true (non-squared) distances; inf where fewer
               than k neighbors were produced (radius-bounded / stop-radius
               tail queries).
      idxs:    (Q, k) int32 dataset indices; the sentinel N marks padding.
      n_tests: candidate distance evaluations performed (the paper's
               "intersection tests" work metric); 0 means "not counted"
               (backends whose engine doesn't meter work).
      found:   optional (Q,) int count of in-radius neighbors seen for each
               query by the round that produced its answer (fixed-radius
               semantics; < k flags an unresolved tail query).
      rounds:  [RoundStats], empty for single-shot backends.
      timings: per-call wall-clock + counters, e.g. ``query_seconds``,
               ``grid_build_seconds``, ``grid_builds``, ``grid_cache_hits``,
               ``warm_start_radius``.
      start_radius / final_radius: first and last radius actually searched
               (None where the notion doesn't apply, e.g. brute force).
      backend: registry name of the backend that produced this result.
      metric:  registry name of the distance metric ``dists`` is measured
               in ("l2" unless the query asked otherwise).
    """

    dists: np.ndarray
    idxs: np.ndarray
    n_tests: int
    backend: str = ""
    found: Optional[np.ndarray] = None
    rounds: list = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)
    start_radius: Optional[float] = None
    final_radius: Optional[float] = None
    metric: str = "l2"

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def total_tests(self) -> int:
        """Legacy alias (pre-API ``TrueKNNResult`` field name)."""
        return self.n_tests

    @property
    def total_seconds(self) -> float:
        # fused multi-round searches run as ONE dispatch: their rounds carry
        # seconds=0.0, and the wall time lives in timings["query_seconds"]
        t = sum(r.seconds for r in self.rounds) if self.rounds else 0.0
        return t or float(self.timings.get("query_seconds", 0.0))


@dataclasses.dataclass
class RangeResult:
    """Ragged range-search answer (``RangeSpec``) in CSR layout.

    Row i's neighbors live at ``idxs[offsets[i]:offsets[i+1]]`` /
    ``dists[offsets[i]:offsets[i+1]]``, sorted nearest-first.  Every listed
    neighbor satisfies ``dist <= radius`` in ``metric``; when
    ``max_neighbors`` clipped a row, ``truncated[i]`` is True and the row
    holds the *nearest* m (never an arbitrary subset).

    Attributes:
      offsets: (Q+1,) int64 row starts; ``offsets[0] == 0``,
               ``offsets[-1] == len(idxs)``.
      idxs:    (nnz,) int32 dataset indices.
      dists:   (nnz,) float32 distances in ``metric``.
      radius:  the ball radius searched (metric units).
      truncated: optional (Q,) bool, rows clipped by ``max_neighbors``.
      n_tests / backend / metric / timings: as on ``KNNResult``.
    """

    offsets: np.ndarray
    idxs: np.ndarray
    dists: np.ndarray
    radius: float
    n_tests: int = 0
    backend: str = ""
    metric: str = "l2"
    truncated: Optional[np.ndarray] = None
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def n_queries(self) -> int:
        return len(self.offsets) - 1

    @property
    def counts(self) -> np.ndarray:
        """(Q,) neighbors per query."""
        return np.diff(self.offsets)

    def neighbors(self, i: int):
        """(idxs, dists) of query ``i``, nearest-first."""
        sl = slice(int(self.offsets[i]), int(self.offsets[i + 1]))
        return self.idxs[sl], self.dists[sl]

    def to_padded(self, k: Optional[int] = None, *, n_points: Optional[int] = None):
        """Dense (Q, k) view: inf-padded dists, sentinel-padded idxs.

        ``k`` defaults to the longest row; ``n_points`` sets the idx
        sentinel (defaults to ``idxs.max() + 1`` — pass the real N when the
        result might be empty)."""
        counts = self.counts
        k = int(k if k is not None else (counts.max() if counts.size else 0))
        sentinel = int(
            n_points
            if n_points is not None
            else (self.idxs.max() + 1 if len(self.idxs) else 0)
        )
        q = self.n_queries
        dd = np.full((q, k), np.inf, np.float32)
        ii = np.full((q, k), sentinel, np.int32)
        for i in range(q):
            idx, dst = self.neighbors(i)
            m = min(len(idx), k)
            dd[i, :m] = dst[:m]
            ii[i, :m] = idx[:m]
        return dd, ii


def slice_rows(res, m: int):
    """First ``m`` query rows of a result (row-padded batches strip their
    padding here — prepared plans pad query counts to canonical shapes, the
    sharded fabric pads per-shard visit-sets; both slice back before any
    caller sees the answer).  Per-row arrays are sliced; batch-level
    telemetry (``n_tests``, ``rounds``, ``timings``) is kept as-is — the
    padded rows were real work the engines actually did."""
    if isinstance(res, RangeResult):
        nnz = int(res.offsets[m])
        return dataclasses.replace(
            res,
            offsets=res.offsets[: m + 1],
            idxs=res.idxs[:nnz],
            dists=res.dists[:nnz],
            truncated=None if res.truncated is None else res.truncated[:m],
        )
    return dataclasses.replace(
        res,
        dists=res.dists[:m],
        idxs=res.idxs[:m],
        found=None if res.found is None else res.found[:m],
    )


# -- tombstone masks and per-row filters (the mutable-index subsystem) ------


def mask_tombstones(dists, idxs, tombstones, sentinel: int):
    """Mask deleted dataset ids out of a (Q, k) candidate list.

    Tombstoned slots become inf/sentinel — the same padding form every
    engine emits — so a downstream top-k fold simply never picks them.
    Applying this BEFORE truncation is what keeps a composite answer
    exact: a part that over-fetched by the tombstone count still holds
    the k nearest *live* candidates after the mask.  ``tombstones`` is an
    array-like of dataset ids (empty = no-op); ``sentinel`` must not
    itself be a tombstoned id.
    """
    dists = np.asarray(dists)
    idxs = np.asarray(idxs)
    tomb = np.asarray(tombstones, np.int64).ravel()
    if tomb.size == 0:
        return dists, idxs
    dead = np.isin(idxs, tomb)
    return (
        np.where(dead, np.inf, dists).astype(np.float32),
        np.where(dead, sentinel, idxs).astype(np.int32),
    )


def filter_csr(part: "RangeResult", keep: np.ndarray) -> "RangeResult":
    """Drop CSR entries where ``keep`` ((nnz,) bool) is False, recomputing
    offsets; per-row nearest-first order is preserved (boolean masking is
    stable).  ``truncated`` flags are kept as-is — the caller decides what
    a dropped entry means for them (over-fetched parts stay exact)."""
    rows = np.repeat(np.arange(part.n_queries), part.counts)
    counts = np.bincount(
        rows[keep], minlength=part.n_queries
    ).astype(np.int64)
    offsets = np.zeros((part.n_queries + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    return dataclasses.replace(
        part,
        offsets=offsets,
        idxs=part.idxs[keep],
        dists=part.dists[keep],
    )


def mask_tombstones_csr(part: "RangeResult", tombstones) -> "RangeResult":
    """Drop tombstoned dataset ids from a CSR range part (rows stay
    nearest-first; ``truncated`` flags are preserved — a part that
    over-fetched its row cap by the tombstone count keeps them exact)."""
    tomb = np.asarray(tombstones, np.int64).ravel()
    if tomb.size == 0 or len(part.idxs) == 0:
        return part
    return filter_csr(part, ~np.isin(part.idxs, tomb))


def strip_self_knn(d, i, self_ids, k: int, sentinel: int):
    """Drop each row's own-index entry from a (Q, k+1) merged pool and
    hand back the (Q, k) answer (padding keeps inf/sentinel form) —
    monolithic self-exclusion reproduced after a composite merge."""
    mask = i == self_ids[:, None]
    order = np.argsort(mask, axis=1, kind="stable")  # self slots last
    rows = np.arange(d.shape[0])[:, None]
    d = d[rows, order]
    i = i[rows, order]
    moved = np.take_along_axis(mask, order, axis=1)
    d = np.where(moved, np.inf, d)
    i = np.where(moved, sentinel, i)
    return d[:, :k], i[:, :k]


def strip_self_csr(part: "RangeResult", self_ids) -> "RangeResult":
    """Drop each row's own-index entry from a CSR range part (see
    :func:`strip_self_knn`; parts over-fetch one slot so the strip never
    loses a real neighbor)."""
    rows = np.repeat(np.arange(part.n_queries), part.counts)
    return filter_csr(part, part.idxs != np.asarray(self_ids)[rows])


# -- first-class result merging (the ShardedIndex fabric) -------------------


def topk_merge_rows(dists_a, idxs_a, dists_b, idxs_b, k: int):
    """Row-wise exact top-k merge of two candidate sets.

    Inputs are (Q, ka) / (Q, kb) candidate lists (inf/sentinel padding
    welcome); the output is the (Q, k) nearest of the union, sorted
    ascending with ties broken by ascending index — the same order
    the stable top-k produces in the monolithic engines, which is what makes
    a sharded merge bit-identical to the single-index answer.
    """
    d = np.concatenate([np.asarray(dists_a), np.asarray(dists_b)], axis=1)
    i = np.concatenate([np.asarray(idxs_a), np.asarray(idxs_b)], axis=1)
    order = np.lexsort((i, d), axis=-1)[:, :k]
    rows = np.arange(d.shape[0])[:, None]
    return d[rows, order], i[rows, order]


def merge_knn(
    parts: Sequence["KNNResult"],
    k: int,
    *,
    sentinel: int,
    backend: str = "",
    metric: str = "l2",
    timings: Optional[dict] = None,
    tombstones=None,
) -> "KNNResult":
    """Fold per-shard ``KNNResult`` parts into one exact (Q, k) answer.

    Every part must cover the *same* queries (Q rows each, inf/sentinel
    padding where a shard had nothing for a row) with globally-mapped
    indices; ``sentinel`` is the padding index (the cloud's N).
    ``n_tests`` is summed and ``rounds`` concatenates with re-sequenced
    indices.  ``found`` is summed where every part carries it (None
    otherwise) — only meaningful when the per-part counts genuinely
    partition one global count (e.g. exact per-shard ball populations);
    counts that are *capped* per part (a child's top-k cut) do not, and
    callers should derive their own (the sharded backend reports the
    returned-neighbor count instead).

    ``tombstones`` (dataset ids) are masked out of every part BEFORE the
    top-k fold truncates, so the answer is the exact k nearest *live*
    candidates — provided each part over-fetched by its tombstone count
    (the mutable backend's contract).  The fold is associative and
    commutative under the mask (masking is idempotent and per-slot), so
    fold order over [base, delta1, delta2, ...] never changes answers.
    """
    assert parts, "merge_knn needs at least one part"
    q_total = np.asarray(parts[0].dists).shape[0]
    d = np.full((q_total, k), np.inf, np.float32)
    i = np.full((q_total, k), sentinel, np.int32)
    for p in parts:
        pd, pi = p.dists, p.idxs
        if tombstones is not None:
            pd, pi = mask_tombstones(pd, pi, tombstones, sentinel)
        d, i = topk_merge_rows(d, i, pd, pi, k)
    found = None
    if all(p.found is not None for p in parts):
        found = np.sum([np.asarray(p.found, np.int64) for p in parts], axis=0)
    rounds = []
    for p in parts:
        for rs in p.rounds:
            rounds.append(dataclasses.replace(rs, round_idx=len(rounds)))
    return KNNResult(
        dists=d.astype(np.float32),
        idxs=i.astype(np.int32),
        n_tests=int(sum(int(p.n_tests) for p in parts)),
        backend=backend,
        metric=metric,
        found=found,
        rounds=rounds,
        timings=dict(timings or {}),
    )


def merge_range(
    parts: Sequence["RangeResult"],
    *,
    radius: float,
    max_neighbors: Optional[int] = None,
    backend: str = "",
    metric: str = "l2",
    timings: Optional[dict] = None,
    tombstones=None,
) -> "RangeResult":
    """Fold per-shard CSR ``RangeResult`` parts into one exact answer.

    Parts cover the same Q queries (empty rows where a shard was pruned or
    had no in-ball points) with globally-mapped indices.  Rows come back
    nearest-first with ties broken by ascending index; ``max_neighbors``
    re-truncates each merged row to the nearest m, and the merged
    ``truncated`` flag is exact: a row is truncated iff any part already
    was (its shard alone holds more than m) or the merged row overflows m.

    ``tombstones`` (dataset ids) are dropped from every part BEFORE rows
    are re-truncated at ``max_neighbors``: a part whose row cap was
    over-fetched by its tombstone count (the mutable backend's contract)
    still surfaces the nearest m live neighbors, and its ``truncated``
    flags stay exact (a part capped at m + tombs holds > m live entries
    whenever its flag is set).
    """
    assert parts, "merge_range needs at least one part"
    if tombstones is not None:
        parts = [mask_tombstones_csr(p, tombstones) for p in parts]
    q_total = parts[0].n_queries
    rows = np.concatenate(
        [np.repeat(np.arange(q_total), p.counts) for p in parts]
    )
    dists = np.concatenate([np.asarray(p.dists, np.float32) for p in parts])
    idxs = np.concatenate([np.asarray(p.idxs, np.int32) for p in parts])
    order = np.lexsort((idxs, dists, rows))
    rows, dists, idxs = rows[order], dists[order], idxs[order]
    counts = np.sum([p.counts for p in parts], axis=0, dtype=np.int64)
    part_trunc = [
        p.truncated
        if p.truncated is not None
        else np.zeros((q_total,), bool)
        for p in parts
    ]
    any_trunc = np.logical_or.reduce(part_trunc)
    truncated = None
    if max_neighbors is not None:
        offsets_full = np.zeros((q_total + 1,), np.int64)
        np.cumsum(counts, out=offsets_full[1:])
        rank = np.arange(len(rows)) - offsets_full[rows]
        keep = rank < max_neighbors
        dists, idxs, rows = dists[keep], idxs[keep], rows[keep]
        truncated = any_trunc | (counts > max_neighbors)
        counts = np.minimum(counts, max_neighbors)
    elif any(p.truncated is not None for p in parts):
        truncated = any_trunc
    offsets = np.zeros((q_total + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    return RangeResult(
        offsets=offsets,
        idxs=idxs,
        dists=dists,
        radius=float(radius),
        n_tests=int(sum(int(p.n_tests) for p in parts)),
        backend=backend,
        metric=metric,
        truncated=truncated,
        timings=dict(timings or {}),
    )
