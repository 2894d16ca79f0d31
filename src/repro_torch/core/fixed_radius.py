"""Fixed-radius kNN round on the cell grid (port of
``repro.core.fixed_radius``) — the analogue of paper Alg. 1 (RT-kNNS).

For every query: locate its grid cell, walk the 3^d one-ring stencil's
buckets, drop hash collisions by an exact cell-coord match, score squared
distances, mask padding / self / out-of-radius, and keep the k best by
(d2, candidate position) within the radius.  Also returns, per query, the
count of in-radius neighbors and, per round, the number of candidate
distance evaluations (the paper's "ray-sphere intersection tests").

``grid_round`` is the round as one call with in-place outputs: the CUDA
kernel ``csrc/grid_round.cu`` for tensors on the card, the plain version
``grid_round_plain`` (built on ``_chunk_candidates``, the reference's op
sequence in torch) for tensors on the CPU.  Both also serve the fused
multi-round loop (``repro_torch.core.fused_loop``) through the ``unres``
mask: skipped rows keep their outputs, run rows are replaced, resolved
rows get their round and leave the mask.

The grid picks the kernel's design (``coarse_design``): from
``COARSE_MIN_SLOTS`` mean stencil slots a query on, the wrapper first
sorts the query rows by their linear cell key (``cell_keys``; resolved
rows last in fused mode) on the device, with no host sync, and hands the
kernel the permutation: a block serves the queries of one cell at a time,
staging each stencil bucket through shared memory, and still writes each
row in place.  Below it, each query walks its own stencil in the rows'
own order.  Both designs keep a list of k <= 32 with one thread (in
registers, or in shared memory for the coarse design) and a longer one
with a whole warp (in registers up to k = 1024, in its row above).

A coarse round on few rows is split on the device: the wrapper also
passes the count of rows that run (``unres.sum`` in fused mode, a device
op, not a host read) and a workspace of the rows the extension asks for
(``grid_round_workspace_rows``: sized from the card, never from the
count).  The kernel derives the active tiles T and a split S (and writes
them to ``plan`` where a caller passes one), each split walks a
contiguous share of every pass's stencil slot tiles into the workspace,
and a merge pass (a warp a row) merges the S partial lists, the earlier
split first on equal d2: the unsplit order.  ``grid_round_split_plain`` is
that split and merge in plain PyTorch, in the kernel's order, for any S.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.build import count_launch, extension
from ..kernels.ops import as_f32
from ..kernels.ref import merge_partial_topk
from .grid import Grid, cell_coords_of, hash_coords, stencil_offsets

__all__ = ["fixed_radius_knn", "fixed_radius_round", "grid_round",
           "grid_round_plain", "grid_round_split_plain", "cell_keys",
           "coarse_design", "stencil_slots", "COARSE_MIN_SLOTS"]

#: (rows, 3^d * cap) candidate block per step of the plain version
_CAND_ELEMS = {"cpu": 1 << 21, "cuda": 1 << 25}

#: mean stencil slots a query walks (``stencil_slots``) from which a round
#: takes the kernel's coarse design, which stages buckets through shared
#: memory for the queries of one cell (below it: one thread a query); set
#: from both designs' times on every scheduled grid of four clouds
#: (``chip_smoke.py`` phase 8, PERF.md)
COARSE_MIN_SLOTS = 384


def stencil_slots(grid: Grid) -> float:
    """3^d * N / H: the stencil's cells times the points a bucket holds on
    average, a quarter to a half of the slots a query walks on average (a
    table holds two to four buckets per occupied cell).  Unlike ``cap``,
    which one dense cell sets, it tracks the work per query."""
    return 3 ** len(grid.res) * grid.n_points / grid.table_size


def coarse_design(grid: Grid) -> bool:
    """Whether a round on ``grid`` takes the kernel's coarse design."""
    return stencil_slots(grid) >= COARSE_MIN_SLOTS


def _pad_points(points: torch.Tensor) -> torch.Tensor:
    """Append a sentinel +inf row so bucket-pad gathers resolve harmlessly."""
    sentinel = points.new_full((1, points.shape[1]), math.inf)
    return torch.cat([points, sentinel], 0)


def _chunk_scores(points_padded, buckets, point_cells, origin, inv_cell,
                  res_arr, offs, q, qid, r2: float, *, table_size: int):
    """The candidate block of one chunk, op for op the reference's: the
    stencil's bucket contents (``cand``, non-matching slots set to n), their
    squared distances (NaN as +inf), ``valid`` (matched slots of finite
    queries), ``within`` (valid, not self, d2 <= r2), and ``live`` (chunk,
    S, cap): the in-range stencil cells' slots that hold a point."""
    n = points_padded.shape[0] - 1
    cap = buckets.shape[1]
    chunk = q.shape[0]
    n_cand = offs.shape[0] * cap

    qfin = torch.where(torch.isfinite(q), q, 0.0)  # keep pad-query math finite
    coords = cell_coords_of(qfin, origin, inv_cell, res_arr)
    nbr = coords[:, None, :] + offs[None, :, :]  # (chunk, S, d)
    in_range = torch.all((nbr >= 0) & (nbr < res_arr), dim=-1)  # (chunk, S)
    h = hash_coords(nbr, table_size)  # (chunk, S)
    cand = torch.where(in_range[..., None], buckets[h], n)  # (chunk, S, cap)
    live = cand < n
    # exact cell-coord match kills hash collisions (and duplicates)
    ccell = point_cells[cand]  # (chunk, S, cap, d)
    match = torch.all(ccell == nbr[:, :, None, :], dim=-1)
    cand = torch.where(match, cand, n).reshape(chunk, n_cand)
    cpts = points_padded[cand]  # (chunk, n_cand, d)
    diff = cpts[..., 0] - q[:, None, 0]
    d2 = diff * diff
    for a in range(1, q.shape[1]):  # the reference's FMA chain
        diff = cpts[..., a] - q[:, None, a]
        d2 = torch.addcmul(d2, diff, diff)
    d2 = torch.nan_to_num(d2, nan=math.inf, posinf=math.inf)
    valid = (cand < n) & torch.isfinite(q[:, :1])  # pad queries don't count
    not_self = cand != qid[:, None]
    within = valid & not_self & (d2 <= r2)
    return cand, d2, valid, within, live


def _topk_within(cand, d2, within, k: int, n: int):
    """The k least (d2, position) pairs among the ``within`` candidates,
    (inf, n) past them, and their count."""
    chunk, n_cand = cand.shape
    found = within.sum(-1, dtype=torch.int32)
    d2m = torch.where(within, d2, math.inf)
    kk = min(k, n_cand)
    top_d, arg = torch.sort(d2m, dim=-1, stable=True)
    top_d, arg = top_d[:, :kk], arg[:, :kk]
    top_i = torch.gather(cand, 1, arg)
    top_i = torch.where(torch.isfinite(top_d), top_i, n).to(torch.int32)
    if kk < k:
        pad = (chunk, k - kk)
        top_d = torch.cat([top_d, top_d.new_full(pad, math.inf)], 1)
        top_i = torch.cat([top_i, top_i.new_full(pad, n)], 1)
    return top_d, top_i, found


def _chunk_candidates(
    points_padded,  # (N+1, d) with +inf sentinel row
    buckets,  # (H, cap)
    point_cells,  # (N+1, d) int32 cell coords, sentinel row -2
    origin,
    inv_cell,
    res_arr,  # (d,) int32
    offs,  # (S, d) stencil offsets
    q,  # (chunk, d); rows with non-finite q[:, 0] count nothing
    qid,  # (chunk,) int32
    r2: float,  # squared radius
    *,
    table_size: int,
    k: int,
):
    """One chunk of grid-stencil candidate search, op for op the
    reference's: gather the stencil's bucket contents, score squared
    distances, keep the k best within ``r2`` ordered by (d2, position).

    Returns ``(top_d2 (chunk, k), top_i (chunk, k), found (chunk,),
    valid (chunk, n_cand))``.
    """
    cand, d2, valid, within, _ = _chunk_scores(
        points_padded, buckets, point_cells, origin, inv_cell, res_arr, offs,
        q, qid, r2, table_size=table_size)
    n = points_padded.shape[0] - 1
    return (*_topk_within(cand, d2, within, k, n), valid)


def cell_keys(q, grid: Grid, unres=None):
    """(Q,) int64 linear cell key of each query row: the cell the kernel
    finds for it (non-finite coordinates count as 0, then the clamp to the
    grid), numbered with the last axis fastest.  With ``unres`` (fused
    mode) every resolved row's key is moved past all cells, so a stable
    sort puts the unresolved rows first, each group in cell order."""
    qfin = torch.where(torch.isfinite(q), q, 0.0)
    coords = cell_coords_of(qfin, grid.origin, grid.inv_cell, grid.res_arr)
    key = coords[:, 0].to(torch.int64)
    for a in range(1, q.shape[1]):
        key = key * grid.res[a] + coords[:, a]
    if unres is not None:
        key = key + (unres == 0).to(torch.int64) * math.prod(grid.res)
    return key


def grid_round_plain(points, grid: Grid, q, qid, r2: float, k: int, *, out,
                     tests, unres=None, res_round=None, t: int = 0,
                     executed=None, chunk: int = 2048) -> None:
    """Plain PyTorch version of the grid-round kernel, same contract.

    ``points`` (N, d) f32, ``q`` (Q, d) f32 and ``qid`` (Q,) int32 on the
    grid's device; ``out`` = (d2 (Q, k) f32, idx (Q, k) i32, found (Q,)
    i32) is written in place for the rows that run; ``tests`` (1,) int64
    is added to.  Fused mode: ``unres`` (Q,) uint8 selects the rows to run
    and is cleared where a row finds >= k; ``res_round`` (Q,) int32 gets
    ``t`` there; ``executed`` (1,) int32 is set to 1 if any row ran.
    """
    def rows_of(pts_padded, offs, qr, qi):
        return _chunk_candidates(
            pts_padded, grid.buckets, grid.point_cells, grid.origin,
            grid.inv_cell, grid.res_arr, offs, qr, qi, r2,
            table_size=grid.table_size, k=k)

    _plain_round(rows_of, points, grid, q, qid, k, out=out, tests=tests,
                 unres=unres, res_round=res_round, t=t, executed=executed,
                 chunk=chunk)


def _plain_round(rows_of, points, grid: Grid, q, qid, k: int, *, out, tests,
                 unres, res_round, t: int, executed, chunk: int) -> None:
    """The plain versions' loop over the rows that run, ``chunk`` at most
    a step: ``rows_of(points_padded, offs, q_rows, qid_rows)`` gives each
    step's (d2, idx, found, valid), written back with the fused flags."""
    od, oi, of = out
    rows = (
        torch.arange(q.shape[0], device=q.device)
        if unres is None
        else torch.nonzero(unres).flatten()
    )
    if rows.numel() == 0:
        return
    if executed is not None:
        executed.fill_(1)
    pts_padded = _pad_points(points)
    offs = torch.as_tensor(stencil_offsets(points.shape[1]), device=q.device)
    n_cand = offs.shape[0] * grid.cap
    step = max(1, min(int(chunk), _CAND_ELEMS[q.device.type] // n_cand))
    for i0 in range(0, rows.numel(), step):
        r = rows[i0:i0 + step]
        top_d, top_i, fnd, valid = rows_of(pts_padded, offs, q[r], qid[r])
        od[r] = top_d
        oi[r] = top_i
        of[r] = fnd
        tests += valid.sum(dtype=torch.int64)
        if unres is not None:
            done = r[fnd >= k]
            res_round[done] = t
            unres[done] = 0


def _split_of(live, splits: int, tile: int):
    """(chunk, S, cap) split index of every slot, the kernel's cut: each
    row's pass walks its in-range stencil cells in order, each bucket's
    live slots (from slot 0 up to its fill) in tiles of ``tile``; the G
    tiles of the walk are numbered in order and split s takes [G * s //
    splits, G * (s + 1) // splits)."""
    cap = live.shape[-1]
    tiles = -(-live.sum(-1) // tile)  # (chunk, S): a bucket fills from 0
    first = torch.cumsum(tiles, -1) - tiles
    g = first[..., None] + torch.arange(cap, device=live.device) // tile
    total = tiles.sum(-1)[:, None, None]
    # the s with G * s // splits <= g; every g < G lies in one split
    which = torch.zeros_like(g)
    for s in range(1, splits):
        which += (g >= total * s // splits).to(g.dtype)
    return which


def grid_round_split_plain(points, grid: Grid, q, qid, r2: float, k: int,
                           splits: int, *, tile: int, out, tests, unres=None,
                           res_round=None, t: int = 0, executed=None,
                           chunk: int = 2048) -> None:
    """Plain PyTorch version of a coarse round split ``splits`` ways and
    merged, in the kernel's order (same contract as ``grid_round_plain``,
    and the same outputs bitwise for every ``splits`` and ``tile``).

    Per row, split s keeps the k least (d2, position) pairs and the
    in-radius count of the candidates in its share of the stencil walk
    (``_split_of``, ``tile`` slots a tile: the kernel stages 512 at
    k <= 32, 1024 above), and ``merge_partial_topk`` merges the partial
    lists in split order (the earlier split first on equal d2) and sums the
    counts.  A split's candidates all precede the next split's by position,
    so the merge gives the unsplit order.
    """
    tile = int(tile)
    n = grid.n_points

    def rows_of(pts_padded, offs, qr, qi):
        cand, d2, valid, within, live = _chunk_scores(
            pts_padded, grid.buckets, grid.point_cells, grid.origin,
            grid.inv_cell, grid.res_arr, offs, qr, qi, r2,
            table_size=grid.table_size)
        which = _split_of(live, splits, tile).reshape(cand.shape)
        parts = [_topk_within(cand, d2, within & (which == s), k, n)
                 for s in range(splits)]
        merged = merge_partial_topk(
            *(torch.stack([p[j] for p in parts]) for j in range(3)), k, n)
        return (*merged, valid)

    _plain_round(rows_of, points, grid, q, qid, k, out=out, tests=tests,
                 unres=unres, res_round=res_round, t=t, executed=executed,
                 chunk=chunk)


def _grid_round_cuda(points, grid: Grid, q, qid, r2: float, k: int, *, out,
                     tests, unres=None, res_round=None, t: int = 0,
                     executed=None) -> None:
    """Launch ``csrc/grid_round.cu`` (same contract as the plain version)."""
    od, oi, of = out
    nq, d = q.shape
    n = grid.n_points
    dev = q.device
    expect = (
        (points, torch.float32, (n, d)),
        (grid.buckets, torch.int32, (grid.table_size, grid.cap)),
        (grid.point_cells, torch.int32, (n + 1, d)),
        (grid.origin, torch.float32, (d,)),
        (grid.inv_cell, torch.float32, (d,)),
        (grid.res_arr, torch.int32, (d,)),
        (qid, torch.int32, (nq,)),
        (od, torch.float32, (nq, k)),
        (oi, torch.int32, (nq, k)),
        (of, torch.int32, (nq,)),
        (tests, torch.int64, (1,)),
        (unres, torch.uint8, (nq,)),
        (res_round, torch.int32, (nq,)),
        (executed, torch.int32, (1,)),
    )
    for ten, dtype, shape in expect:
        if ten is None:
            continue
        if (ten.device != dev or ten.dtype != dtype
                or tuple(ten.shape) != shape or not ten.is_contiguous()):
            raise ValueError(
                f"grid_round: expected contiguous {dtype} {shape} on {dev}, "
                f"got {ten.dtype} {tuple(ten.shape)} on {ten.device}"
            )
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("grid_round: queries must be contiguous float32")
    if not 1 <= d <= 3:
        raise ValueError(f"grid_round: 1 <= d <= 3 (one hash prime per axis), got {d}")
    if nq == 0:
        return
    _launch(points, grid, q, qid, r2, k, coarse_design(grid), out=out,
            tests=tests, unres=unres, res_round=res_round, t=t,
            executed=executed)


def _launch(points, grid: Grid, q, qid, r2: float, k: int, tiled: bool, *,
            out, tests, unres=None, res_round=None, t: int = 0,
            executed=None, splits: int = 0, plan=None, ext=None) -> None:
    """One launch of the kernel's coarse (``tiled``) or fine design on
    checked tensors.  The wrapper picks the design with ``coarse_design``;
    ``chip_smoke.py``, the card tests and ``scripts/grid_round_ab.py`` call
    this directly.  Coarse design only: ``splits`` > 0 forces S (0: the
    kernel picks it from the count of rows that run), ``plan`` (2,) int32
    on the card gets the (T, S) the launch used, and ``ext`` is the
    extension to launch (by default this checkout's)."""
    od, oi, of = out
    nq, d = q.shape
    ext = extension() if ext is None else ext
    perm = n_active = None
    ws = (None, None, None)
    if tiled:
        perm = torch.argsort(cell_keys(q, grid, unres), stable=True)
        if unres is not None:  # a device op: no host read
            n_active = unres.sum(dtype=torch.int32).reshape(1)
        rows = ext.grid_round_workspace_rows(d, int(k), nq, unres is not None,
                                             int(splits), q.device.index or 0)
        if rows:
            ws = (torch.empty((rows, k), dtype=torch.float32, device=q.device),
                  torch.empty((rows, k), dtype=torch.int32, device=q.device),
                  torch.empty((rows,), dtype=torch.int32, device=q.device))
    ext.grid_round(
        points, grid.buckets, grid.point_cells, grid.origin, grid.inv_cell,
        grid.res_arr, q, qid, perm, n_active, int(k), float(r2), tiled, od,
        oi, of, unres, res_round, int(t), tests, executed, *ws, plan,
        int(splits),
    )
    count_launch("grid_round", wide=k > 32)


def grid_round(points, grid: Grid, q, qid, r2: float, k: int, *,
               chunk: int = 2048, **kw) -> None:
    """One grid round with in-place outputs (see ``grid_round_plain`` for
    the contract): the CUDA kernel for tensors on the card, the plain
    version (``chunk`` rows per step at most) for tensors on the CPU."""
    if q.device.type == "cuda":
        _grid_round_cuda(points, grid, q, qid, r2, k, **kw)
    else:
        grid_round_plain(points, grid, q, qid, r2, k, chunk=chunk, **kw)


def fixed_radius_round(
    points,
    grid: Grid,
    queries,
    query_ids,
    radius: float,
    k: int,
    *,
    chunk: int = 2048,
):
    """One fixed-radius search round on the grid's device.

    Returns (dists2 (Q,k), idxs (Q,k), found (Q,)) tensors and n_tests
    (int).  Entries beyond the in-radius neighbor set have dist=inf,
    idx=N.  The squared radius is ``float32(radius)**2``, as in the
    reference.
    """
    dev = grid.buckets.device
    q = as_f32(queries, dev)
    qid = torch.as_tensor(query_ids, dtype=torch.int32, device=dev).contiguous()
    pts = as_f32(points, dev)
    nq = q.shape[0]
    k = int(k)
    out = (
        torch.empty((nq, k), dtype=torch.float32, device=dev),
        torch.empty((nq, k), dtype=torch.int32, device=dev),
        torch.empty((nq,), dtype=torch.int32, device=dev),
    )
    tests = torch.zeros((1,), dtype=torch.int64, device=dev)
    r2 = float(np.float32(radius) ** 2)
    grid_round(pts, grid, q, qid, r2, k, out=out, tests=tests, chunk=chunk)
    return (*out, int(tests.item()))


def fixed_radius_knn(points, radius, k, *, queries=None, chunk: int = 2048,
                     device="cuda"):
    """Deprecated shim: paper Alg. 1 via the registry's "fixed_radius"
    backend (self-excluded when queries are the dataset itself).  Builds a
    throwaway index — and therefore a fresh grid — per call; hold a
    ``build_index(points, backend="fixed_radius", radius=r)`` handle to
    amortize the grid across batches.  ``device`` is the index's:
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.

    Returns (dists (Q,k), idxs (Q,k), found (Q,), n_tests).
    """
    from ..api import HybridSpec, build_index
    from ..api.query import warn_deprecated_once

    warn_deprecated_once(
        "repro_torch.core.fixed_radius.fixed_radius_knn",
        "fixed_radius_knn() is deprecated; use build_index(points, "
        "backend='fixed_radius').query(queries, HybridSpec(k, radius)) and "
        "hold the index across batches",
    )
    res = build_index(
        points, backend="fixed_radius", chunk=chunk, device=device
    ).query(queries, HybridSpec(int(k), float(radius)))
    return res.dists, res.idxs, res.found, res.n_tests
