"""Spatial partitioner (port of ``repro.core.partition``) — the shard
layer of the composite-index fabric.

RTNN's core scaling result is that *restricting the search space* is what
makes RT-accelerated neighbor search fast: once the cloud is split into
spatially coherent pieces, a query whose current search radius is r can
only find neighbors in pieces whose bounding box lies within r — every
other piece is pruned without a single distance test.  TrueKNN's iterative
radius growth composes perfectly with that idea: each round's radius bounds
which partitions the round can touch.

This module owns the *geometry* of that split, with no index or device
dependencies (numpy only), so the
``sharded`` backend can use it:

* :func:`morton_codes` — Z-order curve codes for a point set.  Sorting by
  them is the cheap locality transform everything else builds on.
* :func:`partition_points` — split a cloud into ``n_shards`` spatially
  coherent shards (``method="morton"``: equal-size contiguous runs of the
  Z-order; ``method="grid"``: coarse uniform cells greedily packed into
  shards along the Z-order), each with its exact AABB.
* :func:`aabb_min_dists` — per-(query, shard) *lower bounds* on the
  distance from a query to anything inside a shard's AABB, for the L2/L1/L∞
  family.  Metrics with a monotone L2 reduction (cosine) bound through
  AABBs over the transformed cloud — see the sharded backend.

Exactness note: bounds are mathematical lower bounds on real-valued
distances.  The engines compute float32 distances with rounding, so a
pruning decision must deflate the bound slightly before comparing (see
``PRUNE_SLACK`` in the sharded backend) — pruning may then only err on the
side of visiting a shard it could have skipped, never the reverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Partition",
    "partition_points",
    "balanced_shard_count",
    "shard_occupancy",
    "morton_codes",
    "aabb_min_dists",
    "aabb_max_dists",
]


def balanced_shard_count(n_points: int, n_shards: int,
                         n_devices: int) -> int:
    """Device-count-aware shard arity: ``n_shards`` rounded UP to the
    nearest multiple of ``n_devices`` (so placed slots fill every device
    evenly and no padding slot stays empty for the life of the index),
    then clamped to the point count exactly as :func:`partition_points`
    would clamp it.  With ``n_devices <= 1`` (or a cloud too small to fill
    the devices) the requested arity comes back unchanged."""
    n_points = int(n_points)
    n_shards = max(1, int(n_shards))
    n_devices = max(1, int(n_devices))
    if n_devices <= 1 or n_points <= 0:
        return n_shards
    rounded = -(-n_shards // n_devices) * n_devices
    return max(1, min(rounded, n_points))


def shard_occupancy(sizes, slot_shard, n_devices: int) -> list:
    """Per-device point counts for a placed layout: ``slot_shard`` is the
    slot -> shard assignment (-1 = empty slot, len a multiple of
    ``n_devices``), slots map to devices in contiguous groups (the 1-D
    ``NamedSharding`` layout).  The partition layer owns this so both the
    fabric and the serving stats agree on what "occupancy" means."""
    sizes = np.asarray(sizes, np.int64)
    slot_shard = np.asarray(slot_shard, np.int64)
    n_devices = max(1, int(n_devices))
    assert slot_shard.size % n_devices == 0, slot_shard.size
    g = slot_shard.size // n_devices
    out = []
    for i in range(n_devices):
        grp = slot_shard[i * g:(i + 1) * g]
        out.append(int(sizes[grp[grp >= 0]].sum()))
    return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """A spatial split of a point cloud into shards.

    Attributes:
      assign: (N,) int32 shard id of every point.
      shards: tuple of (n_s,) int64 arrays — the *global* point indices of
              each shard (ascending within a shard, so per-shard subsets
              keep the cloud's index order and tie-breaking survives the
              split).
      aabbs:  (S, 2, d) float32 — exact [lo, hi] corners of each shard's
              member points (not the cells that produced them).
      method: "morton" | "grid".
    """

    assign: np.ndarray
    shards: tuple
    aabbs: np.ndarray
    method: str

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray([len(s) for s in self.shards], np.int64)


def morton_codes(points, *, bits: int = 0, lo=None, hi=None) -> np.ndarray:
    """(N,) uint64 Z-order (Morton) codes of ``points``.

    Each axis is quantized to ``bits`` levels over [lo, hi] (the point
    cloud's own bounding box by default) and the bit strings are
    interleaved, so points close on the curve are close in space.  ``bits``
    defaults to the most that fit 64-bit codes for the dimensionality
    (capped at 16 — a 65k-cell resolution per axis is beyond any shard
    granularity this repo uses).

    A 64-bit code holds at most 63 interleaved (bit, axis) pairs, so for
    high-dimensional rows (embeddings) only the leading ``63 // bits``
    axes participate — a shift past bit 63 would silently wrap to zero in
    uint64 and destroy the code entirely, whereas ordering by the leading
    axes keeps a real (if coarser) locality signal.
    """
    pts = np.asarray(points, np.float64)
    assert pts.ndim == 2, pts.shape
    n, d = pts.shape
    if not bits:
        bits = max(1, min(16, 63 // max(min(d, 63), 1)))
    d_used = max(1, min(d, 63 // bits))
    lo = pts.min(0) if lo is None else np.asarray(lo, np.float64)
    hi = pts.max(0) if hi is None else np.asarray(hi, np.float64)
    # map onto [0, 2^bits) and clip the top edge: flooring a [0, 2^bits-1]
    # range instead would starve the last level (fatal at bits=1, where it
    # collapses nearly every coordinate to 0)
    scale = (1 << bits) / np.maximum(hi - lo, 1e-300)
    q = np.clip((pts - lo) * scale, 0, (1 << bits) - 1).astype(np.uint64)
    codes = np.zeros((n,), np.uint64)
    one = np.uint64(1)
    for b in range(bits):
        for a in range(d_used):
            bit = (q[:, a] >> np.uint64(b)) & one
            codes |= bit << np.uint64(b * d_used + a)
    return codes


def _aabbs_of(pts: np.ndarray, shards) -> np.ndarray:
    out = np.empty((len(shards), 2, pts.shape[1]), np.float32)
    for s, idx in enumerate(shards):
        sub = pts[idx]
        out[s, 0] = sub.min(0)
        out[s, 1] = sub.max(0)
    return out


def partition_points(points, n_shards: int, *, method: str = "morton") -> Partition:
    """Split ``points`` into at most ``n_shards`` spatially coherent shards.

    ``method="morton"``: sort by Z-order code, cut the sorted run into
    near-equal contiguous chunks.  Balanced by construction (shard sizes
    differ by at most 1), spatially coherent because the curve is.

    ``method="grid"``: bin into a coarse uniform grid (the ISSUE's "grid
    cells" flavor), walk the occupied cells in Z-order and greedily pack
    whole cells into shards of ~N/S points.  Shards are unions of axis-
    aligned cells — tighter AABBs on gridded data, less balanced on
    skewed data.

    Every shard is non-empty; fewer than ``n_shards`` come back when the
    cloud is too small (or, for "grid", too concentrated) to fill them.
    Within a shard, global indices stay ascending so downstream merges keep
    the monolithic engines' tie order.
    """
    pts = np.asarray(points, np.float32)
    n, d = pts.shape
    if n == 0:
        # empty cloud: one empty shard with a degenerate AABB, so composite
        # indexes can still be *built* empty (mutable bases start this way);
        # the planner short-circuits queries before any pruning runs
        if method not in ("morton", "grid"):
            raise ValueError(
                f"unknown partition method {method!r}; use 'morton' or 'grid'"
            )
        return Partition(
            assign=np.empty((0,), np.int32),
            shards=(np.empty((0,), np.int64),),
            aabbs=np.zeros((1, 2, d), np.float32),
            method=method,
        )
    n_shards = max(1, min(int(n_shards), n))
    if method == "morton":
        order = np.argsort(morton_codes(pts), kind="stable")
        shards = tuple(
            np.sort(chunk) for chunk in np.array_split(order, n_shards)
        )
    elif method == "grid":
        # coarse cells packed along the Z-order.  Start at the smallest
        # per-axis resolution whose cell count covers n_shards, then refine
        # while any single cell outweighs a whole shard (heavy-tailed
        # clouds concentrate in few cells; a cell can never be split, so
        # an over-full cell caps balance).  The 256-per-axis ceiling bounds
        # the loop on degenerate (duplicate-point) data.
        res = 1
        while res**d < n_shards:
            res += 1
        cell_cap = max(1, -(-n // n_shards))  # ceil(n / n_shards)
        while True:
            cell_of = np.clip(
                ((pts - pts.min(0))
                 / np.maximum(pts.max(0) - pts.min(0), 1e-12)
                 * res).astype(np.int64),
                0, res - 1,
            )
            packed = cell_of[:, 0]
            for a in range(1, d):
                packed = packed * res + cell_of[:, a]
            cells, inverse, counts = np.unique(
                packed, return_inverse=True, return_counts=True
            )
            if counts.max() <= cell_cap or res >= 256:
                break
            res *= 2
        coords = np.empty((len(cells), d), np.float64)
        rem = cells.copy()
        for a in range(d - 1, -1, -1):
            coords[:, a] = rem % res
            rem = rem // res
        cell_order = np.argsort(
            morton_codes(coords, lo=np.zeros(d), hi=np.full(d, res - 1 or 1)),
            kind="stable",
        )
        target = n / n_shards
        cell_shard = np.empty((len(cells),), np.int64)
        sid, acc = 0, 0
        for c in cell_order:
            if acc >= target * (sid + 1) and sid < n_shards - 1:
                sid += 1
            cell_shard[c] = sid
            acc += counts[c]
        assign = cell_shard[inverse]
        used = np.unique(assign)
        shards = tuple(np.flatnonzero(assign == s) for s in used)
    else:
        raise ValueError(
            f"unknown partition method {method!r}; use 'morton' or 'grid'"
        )
    assign = np.empty((n,), np.int32)
    for s, idx in enumerate(shards):
        assign[idx] = s
    return Partition(
        assign=assign,
        shards=shards,
        aabbs=_aabbs_of(pts, shards),
        method=method,
    )


def aabb_min_dists(aabbs, queries, metric: str = "l2") -> np.ndarray:
    """(Q, S) lower bounds on the distance from each query to anything in
    each AABB, for the box-friendly metric family.

    The per-axis *excess* ``e = max(lo - q, q - hi, 0)`` is how far the
    query sits outside the box along that axis; the bound is then the
    metric's norm of the excess vector (l2: sqrt(sum e²), l1: sum e,
    linf: max e).  A query inside the box has bound 0.  Computed in
    float64; callers pruning against float32 engine output must deflate
    (see module docstring).
    """
    boxes = np.asarray(aabbs, np.float64)  # (S, 2, d)
    q = np.asarray(queries, np.float64)  # (Q, d)
    lo = boxes[None, :, 0, :]  # (1, S, d)
    hi = boxes[None, :, 1, :]
    e = np.maximum(np.maximum(lo - q[:, None, :], q[:, None, :] - hi), 0.0)
    if metric == "l2":
        return np.sqrt(np.sum(e * e, axis=-1))
    if metric == "l1":
        return np.sum(e, axis=-1)
    if metric == "linf":
        return np.max(e, axis=-1)
    raise ValueError(
        f"no AABB bound for metric {metric!r} (l2/l1/linf only; reducible "
        "metrics bound through their transformed cloud)"
    )


def aabb_max_dists(aabbs, queries, metric: str = "l2") -> np.ndarray:
    """(Q, S) upper bounds on the distance from each query to anything in
    each AABB (the farthest-corner distance) — the termination counterpart
    of :func:`aabb_min_dists`: once a search radius exceeds every shard's
    upper bound, the whole cloud has provably been covered.

    Per axis the farthest box point sits at whichever face is farther
    (``f = max(|q - lo|, |q - hi|)``); the bound is the metric's norm of
    the farthest-corner vector.  Computed in float64; callers comparing
    against float32 engine output should inflate slightly.
    """
    boxes = np.asarray(aabbs, np.float64)  # (S, 2, d)
    q = np.asarray(queries, np.float64)  # (Q, d)
    lo = boxes[None, :, 0, :]  # (1, S, d)
    hi = boxes[None, :, 1, :]
    f = np.maximum(np.abs(q[:, None, :] - lo), np.abs(q[:, None, :] - hi))
    if metric == "l2":
        return np.sqrt(np.sum(f * f, axis=-1))
    if metric == "l1":
        return np.sum(f, axis=-1)
    if metric == "linf":
        return np.max(f, axis=-1)
    raise ValueError(
        f"no AABB bound for metric {metric!r} (l2/l1/linf only; reducible "
        "metrics bound through their transformed cloud)"
    )
