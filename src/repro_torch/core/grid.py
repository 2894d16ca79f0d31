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
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .spans import span

__all__ = ["Grid", "GridCapError", "build_grid", "grid_shape",
           "stencil_offsets", "hash_coords"]

# Teschner et al. spatial-hash primes (one per axis).
_HASH_PRIMES = (73856093, 19349663, 83492791)
_MAX_RES_PER_AXIS = 1 << 20  # keeps packed host-side ids within int64
_U32 = 0xFFFFFFFF


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
    device included) to ``"_seconds"``."""
    t0 = time.perf_counter()
    n_valid, d = pts.shape
    lo, hi = torch.stack(torch.aminmax(pts, dim=0)).cpu().numpy()
    extent = np.maximum(hi - lo, 1e-12)

    radius = float(max(radius, 1e-12))
    res = np.clip(
        np.floor(extent / radius).astype(np.int64), 1, _MAX_RES_PER_AXIS
    )

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
        return table_size, cap, res, cell, lo
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
    return table_size, cap, res, cell, lo


def grid_shape(points, radius: float, *, n_valid: int = 0,
               max_bucket_elems: int = 1 << 25,
               load_factor: float = 0.5) -> tuple:
    """(table_size, cap) that ``build_grid`` would give these arguments,
    from the sizing probe alone (no binning), run on the CPU."""
    pts = np.asarray(points, dtype=np.float32)
    pts = pts[: n_valid or pts.shape[0]]
    table_size, cap, _, _, _ = _size_grid(
        torch.from_numpy(pts), radius,
        max_bucket_elems=max_bucket_elems, load_factor=load_factor,
        force_table_size=0, force_cap=0, probe_cache=None,
    )
    return table_size, cap


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
    ``GridCapError``.
    """
    with span("repro_torch.grid.build"):
        pts_all = np.asarray(points, dtype=np.float32)
        n, d = pts_all.shape
        n_valid = n_valid or n
        dpts = (torch.from_numpy(pts_all) if device_points is None
                else device_points)
        dev = dpts.device
        with span("repro_torch.grid.probe"):
            table_size, cap, res, cell, lo = _size_grid(
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
        return Grid(
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
