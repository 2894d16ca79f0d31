"""Spatial hash grid (port of ``repro.core.grid``) — the analogue of the
paper's BVH.

Every point within radius r of a query lies in the 3^d-cell one-ring
stencil around the query's cell when the cell side is >= r.  Occupied
cells hash (Teschner) into a table of O(#occupied) buckets of fixed
capacity; each point's integer cell coords are kept, so an exact coord
match filters hash collisions out of every candidate list.

The table-sizing probe runs in torch on the device of the points: each
resolution it tries is a floor, a sort of the packed cell ids and a
bincount of their hashes there, and only the occupied-cell count and the
largest bucket come back to the host.  Its arithmetic is the reference's
numpy probe, operation for operation in float32 and int64, so it yields
the reference's (table_size, cap, res, cell, lo) and memo for every input
(probe cache and its hit/miss counters included); the port's memo also
counts the resolutions its probes tried and their wall seconds.  Binning
is a counting sort in torch ops on the same device: a stable argsort, a
bincount, a cumsum and a masked scatter.

A grid whose resolution the probe coarsened (fewer cells than the radius
allows on some axis, so that its capped buckets fit) also carries a
``SubGrid``: the same cloud in cap-free cells of about the build radius,
which the grid round walks to find the candidates that can lie in radius
(``build_subgrid``).  The buckets, cells and counts stay the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .spans import span

__all__ = ["Grid", "GridCapError", "SubGrid", "build_grid", "build_subgrid",
           "grid_shape", "stencil_offsets", "hash_coords", "ref_tests",
           "walk_ranges"]

# Teschner et al. spatial-hash primes (one per axis).
_HASH_PRIMES = (73856093, 19349663, 83492791)
_MAX_RES_PER_AXIS = 1 << 20  # keeps packed host-side ids within int64
_U32 = 0xFFFFFFFF
#: relative and extent-relative slack of a sub-grid cell (see SubGrid)
_SUB_SLACK = 2.0 ** -20
#: the cloud's points a sub-grid's cost estimate is made on
_SUB_SAMPLE = 1024
#: a walk's candidate key holds the point index in its low bits
SUB_INDEX_BITS = 27
_SUB_MAX_POINTS = 1 << SUB_INDEX_BITS


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static-shape spatial hash grid over a point set.

    Attributes:
      buckets:     (H, cap) int32 point indices, padded with N (sentinel).
      point_cells: (N+1, d) int32 cell coords per point; sentinel row = -2.
      origin:      (d,) float32 lower corner of the bounding box.
      inv_cell:    (d,) float32 reciprocal effective cell size per axis.
      res:         (d,) host ints — virtual cells per axis.
      res_arr:     (d,) int32 tensor copy of ``res``.
      table_size:  int, H (pow2).
      cap:         int, bucket capacity (pow2).
      n_points:    int.
      cell_size:   (d,) np.float32 effective cell size (>= build radius).
    The tensors live on the device of the points the grid was built from.
    """

    buckets: torch.Tensor
    point_cells: torch.Tensor
    origin: torch.Tensor
    inv_cell: torch.Tensor
    res: tuple
    res_arr: torch.Tensor
    table_size: int
    cap: int
    n_points: int
    cell_size: np.ndarray
    sub: Optional["SubGrid"] = None


@dataclasses.dataclass(frozen=True)
class SubGrid:
    """The cloud's finite points in cap-free cells of side about ``c``,
    beside a coarsened reference grid, for the grid round's walk.

    Attributes:
      pts:        (M, 4) float32: the finite valid points (x, y, z, 0 past
                  d) sorted by linear sub-cell key, the last axis fastest,
                  stably (index order within a cell); column 3 holds each
                  point's index as int32 bits.
      cell_start: (C + 1,) int32: the occupied sub-cells' first rows in
                  ``pts``, in key order, then M.
      cell_z:     (C,) int32: each occupied sub-cell's coordinate on the
                  last axis.
      col_start:  (n_cols + 1,) int32: the first occupied sub-cell of each
                  column (a cell of the first d - 1 axes, linear, the last
                  of them fastest), then C.
      origin, inv_cell, res, res_arr: the sub-cells, as ``Grid``'s.
      r2_cover:   float: the squared radii up to which a round may walk it.
      ref_keys:   (R,) int64: the reference grid's occupied cells' linear
                  keys (``fixed_radius.cell_keys`` numbering), sorted.
      ref_cum:    (R + 1,) int64: their point counts, summed in key order
                  from 0 (a round's n_tests come from these).
      walk_per_row, tests_per_row: float: on up to ``_SUB_SAMPLE`` of the
                  cloud's own points, evenly spaced, the mean distances a
                  row's walk computes (its sub-stencil's points) and the
                  mean tests the reference charges it (its stencil's).

    The bound it keeps: every point p with a float32 ``d2(p, q) <= r2``
    (the round's FMA chain over p - q), for ``r2 <= r2_cover``, lies in
    the 3^d sub-cells around q's.  Such p and q are finite and
    |p_a - q_a| <= sqrt(r2) * (1 + 4 eps) on each axis (eps = 2^-24: d2
    is a sum of nonnegative terms, rounded at most three times, and each
    difference once).  The sub-cell of x is ``floor(fl(fl(x - lo) *
    inv))`` clamped to [0, res - 1]; with u = (x - lo) / cell its
    computed value is u * (1 + t), |t| <= 3.01 eps, and |u| <= res + 1 for
    both points (p lies in the cloud's box, q within one cell of it).
    So the two differ by at most |p_a - q_a| / cell + 6.1 eps * (res + 1)
    < 1 whenever cell >= sqrt(r2) * (1 + 2^-20) + 2^-20 * extent, which
    ``build_subgrid`` keeps on every axis (and the clamp keeps |a - b| <=
    1).  On kitti's map (x - lo up to 270, one float32 ulp 1.5e-5 there)
    the extent term adds 2.6e-4 to a 0.165 cell.

    Bytes on the device: 16 a finite point (``pts``), 8 an occupied
    sub-cell, 4 a column (at most 4 M + 2^16 columns: a larger table
    widens the columns' cells instead), 16 an occupied reference cell;
    16.8-35.2 MB a cached grid on the benchmark's 2^20-point clouds (the
    finest sub-grids hold the most cells and columns).
    """

    pts: torch.Tensor
    cell_start: torch.Tensor
    cell_z: torch.Tensor
    col_start: torch.Tensor
    origin: torch.Tensor
    inv_cell: torch.Tensor
    res: tuple
    res_arr: torch.Tensor
    r2_cover: float
    ref_keys: torch.Tensor
    ref_cum: torch.Tensor
    walk_per_row: float
    tests_per_row: float


def stencil_offsets(d: int) -> np.ndarray:
    """(3^d, d) integer offsets of the one-ring stencil."""
    grids = np.meshgrid(*([np.arange(-1, 2)] * d), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def hash_coords(coords, table_size: int):
    """Spatial hash of integer cell coords -> bucket id in [0, table_size).

    Works for torch integer tensors (uint32 wraparound done in int64 with
    ``& 0xFFFFFFFF``; returns int64) and numpy arrays (returns int64).
    """
    if isinstance(coords, torch.Tensor):
        u = coords.to(torch.int64) & _U32
        h = (u[..., 0] * _HASH_PRIMES[0]) & _U32
        for a in range(1, coords.shape[-1]):
            h = h ^ ((u[..., a] * _HASH_PRIMES[a]) & _U32)
        return h & (table_size - 1)
    u = coords.astype(np.uint32)
    h = u[..., 0] * np.uint32(_HASH_PRIMES[0])
    for a in range(1, coords.shape[-1]):
        h = h ^ (u[..., a] * np.uint32(_HASH_PRIMES[a]))
    return (h & np.uint32(table_size - 1)).astype(np.int64)


def cell_coords_of(points, origin, inv_cell, res_arr):
    """Per-axis integer cell coords, clamped to the virtual grid.

    The clamp runs in float32 before the int32 conversion: that is the
    reference's saturating convert followed by its clip (res <= 2^20 is
    exact in float32), with no out-of-range float-to-int cast."""
    c = torch.floor((points - origin) * inv_cell)
    c = torch.minimum(torch.clamp_min(c, 0.0), (res_arr - 1).to(c.dtype))
    return c.to(torch.int32)


def _bin_points(points, origin, inv_cell, res_arr, *, table_size: int,
                cap: int, n_valid: int):
    """Counting-sort points into hash buckets.

    Rows >= n_valid are padding: never binned, cell coords -2 (match
    nothing).  Returns (buckets (H, cap), point_cells (N+1, d))."""
    n = points.shape[0]
    dev = points.device
    valid = torch.arange(n, device=dev) < n_valid
    coords = cell_coords_of(
        torch.where(torch.isfinite(points), points, 0.0), origin, inv_cell,
        res_arr,
    )
    h = torch.where(valid, hash_coords(coords, table_size), table_size - 1)
    order = torch.argsort(h, stable=True)
    sorted_h = h[order]
    counts = torch.bincount(
        torch.where(valid, h, table_size), minlength=table_size + 1
    )[:table_size]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=dev) - starts[sorted_h]  # rank in bucket
    keep = (slot < cap) & (order < n_valid)
    buckets = torch.full((table_size, cap), n, dtype=torch.int32, device=dev)
    buckets[sorted_h[keep], slot[keep]] = order[keep].to(torch.int32)
    coords = torch.where(valid[:, None], coords, -2)
    sentinel = torch.full((1, points.shape[1]), -2, dtype=torch.int32,
                          device=dev)
    point_cells = torch.cat([coords, sentinel], 0)
    return buckets, point_cells


class GridCapError(ValueError):
    """A forced bucket capacity is below what the points need."""


def _size_grid(pts, radius: float, *, max_bucket_elems: int,
               load_factor: float, force_table_size: int, force_cap: int,
               probe_cache: dict):
    """The reference's table-sizing probe, run in torch on the device of
    the valid rows ``pts`` (a float32 tensor): (table_size, cap, res, cell,
    lo), coarsening the resolution until the table fits
    ``max_bucket_elems`` (not under a forced shape).  The bounding box
    comes to the host as one read (min and max are exact); the resolutions
    and cell sizes are the reference's numpy there.  Each resolution tried
    is the reference's floor, clip, pack, distinct count and hash
    occupancy on the device, where float32 division and int64 arithmetic
    give numpy's bits, and brings two integers back.  A probe that the
    memo does not answer adds the resolutions it tried to
    ``probe_cache["_passes"]`` and its wall seconds (its reads from the
    device included) to ``"_seconds"``.  Also returns whether the
    resolution is below the first one tried on some axis (coarsened)."""
    t0 = time.perf_counter()
    n_valid, d = pts.shape
    lo, hi = torch.stack(torch.aminmax(pts, dim=0)).cpu().numpy()
    extent = np.maximum(hi - lo, 1e-12)

    radius = float(max(radius, 1e-12))
    res = np.clip(
        np.floor(extent / radius).astype(np.int64), 1, _MAX_RES_PER_AXIS
    )
    first = res

    use_cache = (
        probe_cache is not None and not force_table_size and not force_cap
    )
    probe_key = (n_valid, tuple(int(x) for x in res)) if use_cache else None
    cached = probe_cache.get(probe_key) if use_cache else None
    if cached is not None:
        probe_cache["_hits"] = probe_cache.get("_hits", 0) + 1
        table_size, cap, res_t = cached
        res = np.asarray(res_t, np.int64)
        cell = (extent / res).astype(np.float32)
        return table_size, cap, res, cell, lo, bool((res < first).any())
    dev = pts.device
    shifted = pts - torch.from_numpy(lo).to(dev)
    passes = 0
    while True:
        passes += 1
        cell = (extent / res).astype(np.float32)
        # float32 divide, floor, int64 cast, then the clip in int64: a
        # non-finite coordinate casts to anything, but its axis has res 1
        coords = torch.floor(shifted / torch.from_numpy(cell).to(dev))
        coords = torch.minimum(coords.to(torch.int64).clamp_min(0),
                               torch.from_numpy(res - 1).to(dev))
        # pack to a unique id per occupied cell (exact in int64)
        packed = coords[:, 0]
        for a in range(1, d):
            packed = packed * int(res[a]) + coords[:, a]
        n_occ = torch.unique(packed).numel()
        table_size = force_table_size or _next_pow2(
            max(int(n_occ / load_factor), 16)
        )
        occ = torch.bincount(hash_coords(coords, table_size),
                             minlength=table_size)
        needed_cap = _next_pow2(max(int(occ.max()), 1))
        if force_cap:
            # caller pre-computed a shared shape; it must be adequate —
            # exactness over silent truncation.
            if needed_cap > force_cap:
                raise GridCapError(
                    f"points need bucket cap {needed_cap} > forced {force_cap}"
                )
            cap = force_cap
            break
        cap = needed_cap
        if table_size * cap <= max_bucket_elems or int(res.max()) == 1:
            break
        res = np.maximum(res // 2, 1)  # coarsen (cells grow — always safe)
    if use_cache:
        probe_cache["_misses"] = probe_cache.get("_misses", 0) + 1
        probe_cache[probe_key] = (table_size, cap, tuple(int(r) for r in res))
    if probe_cache is not None:
        probe_cache["_passes"] = probe_cache.get("_passes", 0) + passes
        probe_cache["_seconds"] = (probe_cache.get("_seconds", 0.0)
                                   + time.perf_counter() - t0)
    return table_size, cap, res, cell, lo, bool((res < first).any())


def grid_shape(points, radius: float, *, n_valid: int = 0,
               max_bucket_elems: int = 1 << 25,
               load_factor: float = 0.5) -> tuple:
    """(table_size, cap) that ``build_grid`` would give these arguments,
    from the sizing probe alone (no binning), run on the CPU."""
    pts = np.asarray(points, dtype=np.float32)
    pts = pts[: n_valid or pts.shape[0]]
    table_size, cap, *_ = _size_grid(
        torch.from_numpy(pts), radius,
        max_bucket_elems=max_bucket_elems, load_factor=load_factor,
        force_table_size=0, force_cap=0, probe_cache=None,
    )
    return table_size, cap


def _linear(coords, res, axes):
    """int64 linear key of integer coords over ``axes``, the last fastest."""
    key = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                      device=coords.device)
    for a in axes:
        key = key * int(res[a]) + coords[..., a].to(torch.int64)
    return key


def build_subgrid(grid: Grid, points, radius: float, *,
                  n_valid: int = 0) -> Optional[SubGrid]:
    """The ``SubGrid`` of ``grid``: its valid rows of ``points`` (a tensor
    on the grid's device) that are finite on every axis, in cap-free cells
    that cover squared radii up to ``r2_cover`` = (radius * (1 + 2^-16))^2
    (see ``SubGrid`` for the bound), sorted on the device, with its cost
    estimate on up to ``_SUB_SAMPLE`` of the points (a few host reads).
    None where no row is finite or the cloud has more than
    ``_SUB_MAX_POINTS`` rows."""
    n, d = points.shape
    n_valid = n_valid or n
    if n > _SUB_MAX_POINTS or not 1 <= d <= 3:
        return None
    dev = points.device
    pts = points[:n_valid].to(torch.float32)
    rows = torch.nonzero(torch.isfinite(pts).all(1)).flatten()
    m = rows.numel()
    if m == 0:
        return None
    p = pts[rows]
    lo, hi = torch.stack(torch.aminmax(p, dim=0)).cpu().numpy()
    extent = hi.astype(np.float64) - lo.astype(np.float64)
    r_cover = max(float(radius), 1e-12) * (1.0 + 2.0 ** -16)
    c_min = (r_cover * (1.0 + _SUB_SLACK)
             + _SUB_SLACK * float(extent.max())) * (1.0 + _SUB_SLACK)
    res = np.clip(np.floor(extent / c_min), 1,
                  _MAX_RES_PER_AXIS).astype(np.int64)
    # the column table stays within 4 entries a point: widen its cells
    while d > 1 and math.prod(res[:-1]) > max(4 * m, 1 << 16):
        a = int(np.argmax(res[:-1]))
        res[a] = max(res[a] // 2, 1)
    # float32 rounds the side by at most 2^-24 of it, within c_min's slack
    cell = np.maximum(extent / res, c_min).astype(np.float32)
    res_t = tuple(int(r) for r in res)
    origin = torch.from_numpy(lo).to(dev)
    inv_cell = torch.from_numpy(
        np.asarray(1.0 / cell, np.float32)).to(dev)
    res_arr = torch.tensor(res_t, dtype=torch.int32, device=dev)
    sc = cell_coords_of(p, origin, inv_cell, res_arr)
    col = _linear(sc, res_t, range(d - 1))
    key, order = torch.sort(col * res_t[-1] + sc[:, -1], stable=True)
    packed = torch.zeros((m, 4), dtype=torch.float32, device=dev)
    packed[:, :d] = p[order]
    packed[:, 3] = rows[order].to(torch.int32).view(torch.float32)
    cells, counts = torch.unique_consecutive(key, return_counts=True)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cell_start = torch.cat([zero, torch.cumsum(counts, 0)])
    n_cols = math.prod(res_t[:-1])
    col_start = torch.searchsorted(
        cells // res_t[-1], torch.arange(n_cols + 1, device=dev))
    # the reference's cells and their points, for its n_tests
    ref_cells, ref_counts = torch.unique(
        _linear(grid.point_cells[:n_valid], grid.res, range(d)),
        return_counts=True)
    sub = SubGrid(
        pts=packed,
        cell_start=cell_start.to(torch.int32),
        cell_z=(cells % res_t[-1]).to(torch.int32),
        col_start=col_start.to(torch.int32),
        origin=origin,
        inv_cell=inv_cell,
        res=res_t,
        res_arr=res_arr,
        r2_cover=r_cover * r_cover,
        ref_keys=ref_cells,
        ref_cum=torch.cat([zero, torch.cumsum(ref_counts, 0)]),
        walk_per_row=0.0,
        tests_per_row=0.0,
    )
    sample = p[torch.linspace(0, m - 1, min(m, _SUB_SAMPLE),
                              device=dev).to(torch.int64)]
    begin, end = walk_ranges(sub, sample)
    tests = ref_tests(grid, sub, sample)
    return dataclasses.replace(
        sub, walk_per_row=float((end - begin).sum()) / sample.shape[0],
        tests_per_row=float(tests.sum()) / sample.shape[0])


# -- a row's cells: the sub-grid walk's ranges and the reference's tests -----


def _column_offsets(d: int, device) -> torch.Tensor:
    """(3^(d-1), d-1) offsets of a stencil's columns: the one-ring over the
    first d - 1 axes, in ``stencil_offsets`` order."""
    if d == 1:
        return torch.zeros((1, 0), dtype=torch.int64, device=device)
    return torch.as_tensor(stencil_offsets(d - 1), device=device).to(
        torch.int64)


def _columns(coords, res_arr, offs):
    """Each row's stencil columns: (rows, 3^(d-1), d-1) coords and whether
    each lies in the grid."""
    d = coords.shape[1]
    nb = coords[:, None, :d - 1] + offs[None]
    ok = ((nb >= 0) & (nb < res_arr[:d - 1].to(torch.int64))).all(-1)
    return nb, ok


def ref_tests(grid: Grid, sub: SubGrid, q) -> torch.Tensor:
    """(rows,) int64: the reference's tests of each row on ``grid``, the
    points of its in-range stencil cells (0 for a row with a non-finite
    first coordinate), from ``sub``'s per-cell counts: per column, the
    cells of the three last-axis coordinates around the row's (clamped to
    the grid) are one range of keys."""
    d = q.shape[1]
    qc = cell_coords_of(torch.where(torch.isfinite(q), q, 0.0), grid.origin,
                        grid.inv_cell, grid.res_arr).to(torch.int64)
    nb, ok = _columns(qc, grid.res_arr, _column_offsets(d, q.device))
    last = grid.res[-1]
    base = _linear(nb, grid.res, range(d - 1)) * last
    zlo = (qc[:, -1:] - 1).clamp(min=0)
    zhi = (qc[:, -1:] + 1).clamp(max=last - 1)
    lo = torch.searchsorted(sub.ref_keys, (base + zlo).contiguous())
    hi = torch.searchsorted(sub.ref_keys, (base + zhi + 1).contiguous())
    per_col = torch.where(ok & (zlo <= zhi), sub.ref_cum[hi] - sub.ref_cum[lo],
                          0)
    return per_col.sum(1) * torch.isfinite(q[:, 0])


def _lower_bound(values, lo, hi, x):
    """Elementwise: the first position p in [lo, hi) with values[p] >= x
    (hi where none), by bisection; ``values`` is sorted within each
    range."""
    lo, hi = lo.clone(), hi.clone()
    last = max(values.numel() - 1, 0)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        below = values[mid.clamp(max=last)].to(torch.int64) < x
        run = lo < hi
        lo = torch.where(run & below, mid + 1, lo)
        hi = torch.where(run & ~below, mid, hi)
    return lo


def walk_ranges(sub: SubGrid, q):
    """(rows, 3^(d-1)) int64 begin and end in ``sub.pts`` of each row's
    sub-stencil columns: in each column in the sub-grid, the occupied cells
    at the row's last-axis coordinate +-1, one contiguous range of points;
    empty for a row with a non-finite coordinate."""
    d = q.shape[1]
    sc = cell_coords_of(torch.where(torch.isfinite(q), q, 0.0), sub.origin,
                        sub.inv_cell, sub.res_arr).to(torch.int64)
    nb, ok = _columns(sc, sub.res_arr, _column_offsets(d, q.device))
    ok = ok & torch.isfinite(q).all(1)[:, None]
    col = torch.where(ok, _linear(nb, sub.res, range(d - 1)), 0)
    c0 = sub.col_start[col].to(torch.int64)
    c1 = sub.col_start[col + 1].to(torch.int64)
    z = sc[:, -1:].expand_as(c0)
    begin = sub.cell_start[_lower_bound(sub.cell_z, c0, c1, z - 1)]
    end = sub.cell_start[_lower_bound(sub.cell_z, c0, c1, z + 2)]
    begin = begin.to(torch.int64)
    return begin, torch.where(ok, end.to(torch.int64), begin)


def build_grid(
    points,
    radius: float,
    *,
    device_points=None,
    max_bucket_elems: int = 1 << 25,
    load_factor: float = 0.5,
    force_table_size: int = 0,
    force_cap: int = 0,
    n_valid: int = 0,
    probe_cache: dict = None,
) -> Grid:
    """Build a hash grid whose effective cell size is >= ``radius`` per axis.

    ``points`` is the host copy ((N, d) array); ``device_points`` the same
    cloud as a tensor, probed and binned on its device (the CPU when
    None).  ``n_valid``: rows beyond
    it are padding, excluded from the index.  ``probe_cache``: optional
    per-cloud memo of the sizing probe, keyed by (n_valid, initial res);
    ``"_hits"`` / ``"_misses"`` count lookups, ``"_passes"`` /
    ``"_seconds"`` the probes' resolutions and wall time.  The memo is
    ignored under ``force_table_size`` /
    ``force_cap``, where a cap below what the points need raises
    ``GridCapError``.  A grid the probe coarsened, outside a forced shape,
    carries its ``SubGrid`` (``build_subgrid`` at ``radius``).
    """
    with span("repro_torch.grid.build"):
        pts_all = np.asarray(points, dtype=np.float32)
        n, d = pts_all.shape
        n_valid = n_valid or n
        dpts = (torch.from_numpy(pts_all) if device_points is None
                else device_points)
        dev = dpts.device
        with span("repro_torch.grid.probe"):
            table_size, cap, res, cell, lo, coarsened = _size_grid(
                dpts[:n_valid].to(torch.float32), radius,
                max_bucket_elems=max_bucket_elems, load_factor=load_factor,
                force_table_size=force_table_size, force_cap=force_cap,
                probe_cache=probe_cache,
            )

        res_t = tuple(int(r) for r in res)
        with span("repro_torch.grid.bin"):
            origin = torch.from_numpy(lo).to(dev)
            inv_cell = torch.from_numpy(
                np.asarray(1.0 / cell, np.float32)).to(dev)
            res_arr = torch.tensor(res_t, dtype=torch.int32, device=dev)
            buckets, point_cells = _bin_points(
                dpts, origin, inv_cell, res_arr,
                table_size=table_size, cap=cap, n_valid=n_valid,
            )
        grid = Grid(
            buckets=buckets,
            point_cells=point_cells,
            origin=origin,
            inv_cell=inv_cell,
            res=res_t,
            res_arr=res_arr,
            table_size=table_size,
            cap=cap,
            n_points=n,
            cell_size=cell,
        )
        if coarsened and not force_table_size and not force_cap:
            with span("repro_torch.grid.subgrid"):
                grid = dataclasses.replace(grid, sub=build_subgrid(
                    grid, dpts, radius, n_valid=n_valid))
        return grid
