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

A grid the sizing probe coarsened carries a cap-free ``SubGrid`` of cells
of about its build radius (``core.grid``), and a round on it may take a
third design, the walk (``round_design``: the kNN loop's rounds always,
every-row rounds where the sub-grid's estimate says the walk's distances
cost less than the reference's tests): each row walks its 3^d sub-cells, the
points of a column's three cells one contiguous range, and keeps a
candidate only where the reference's stencil holds it (its cell within one
of the query's on every axis).  The reference's answer comes out bitwise:
the list is ordered by a 64-bit key of (d2 bits, stencil index of the
candidate's reference cell, index), which is the reference's (d2,
position) order since binning is stable; ``found`` counts the kept
candidates in radius; n_tests are the reference's, the points of its
stencil cells, from per-cell counts made at build.  ``evaluated`` counts
the distances the walk computed.  ``grid_round_subgrid_plain`` is the walk
in plain PyTorch, in the kernel's order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.build import count_launch, extension
from ..kernels.ops import as_f32
from ..kernels.ref import merge_partial_topk
from .grid import (SUB_INDEX_BITS, Grid, _linear, cell_coords_of, hash_coords,
                   ref_tests, stencil_offsets, walk_ranges)

__all__ = ["fixed_radius_knn", "fixed_radius_round", "grid_round",
           "grid_round_plain", "grid_round_split_plain",
           "grid_round_subgrid_plain", "cell_keys",
           "coarse_design", "round_design", "stencil_slots", "walk_order",
           "COARSE_MIN_SLOTS", "WALK_COST", "WALK_MAX_K"]

#: (rows, 3^d * cap) candidate block per step of the plain version
_CAND_ELEMS = {"cpu": 1 << 21, "cuda": 1 << 25}

#: mean stencil slots a query walks (``stencil_slots``) from which a round
#: takes the kernel's coarse design, which stages buckets through shared
#: memory for the queries of one cell (below it: one thread a query); set
#: from both designs' times on every scheduled grid of four clouds
#: (``chip_smoke.py`` phase 8, PERF.md)
COARSE_MIN_SLOTS = 384

#: the longest list the walk keeps (a warp's register list); longer ones
#: take the reference designs
WALK_MAX_K = 1024

#: what a distance the walk computes costs, in tests of the design it
#: would replace: the coarse design stages each candidate once for the
#: rows of a cell, the fine design and the walk gather it a row.  Set from
#: every-row rounds on the H100, where the walk lost at 1/3 and 1 of the
#: coarse design's tests a row and gained from 1/8 (``chip_smoke.py``
#: phase 8, PERF.md)
WALK_COST = {"coarse": 4.0, "fine": 1.0}


def stencil_slots(grid: Grid) -> float:
    """3^d * N / H: the stencil's cells times the points a bucket holds on
    average, a quarter to a half of the slots a query walks on average (a
    table holds two to four buckets per occupied cell).  Unlike ``cap``,
    which one dense cell sets, it tracks the work per query."""
    return 3 ** len(grid.res) * grid.n_points / grid.table_size


def coarse_design(grid: Grid) -> bool:
    """Whether a round on ``grid`` takes the kernel's coarse design."""
    return stencil_slots(grid) >= COARSE_MIN_SLOTS


def round_design(grid: Grid, r2: float, k: int, fused: bool = False) -> str:
    """The design a round at squared radius ``r2`` takes on ``grid``: the
    kernel's ``"coarse"`` or ``"fine"`` design (``coarse_design``), or
    ``"walk"`` where the grid carries a sub-grid that covers ``r2`` (the
    probe coarsened it), k <= ``WALK_MAX_K``, and the walk's distances cost
    less than the tests they replace.  In ``fused`` mode (the kNN loop's
    rounds) they do: a row runs there only while a smaller radius left it
    unresolved, with fewer than k points within half the round's radius,
    so its sub-stencil holds few points wherever the cloud is dense.  Every
    other round runs each of its rows: there the sub-grid's estimate on the
    cloud's own points decides (``walk_per_row`` distances at
    ``WALK_COST`` tests each against ``tests_per_row``)."""
    ref = "coarse" if coarse_design(grid) else "fine"
    sub = grid.sub
    if sub is None or r2 > sub.r2_cover or k > WALK_MAX_K:
        return ref
    if fused or WALK_COST[ref] * sub.walk_per_row <= sub.tests_per_row:
        return "walk"
    return ref


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


def cell_keys(q, grid, unres=None):
    """(Q,) int64 linear cell key of each query row in ``grid`` (a ``Grid``
    or its ``SubGrid``): the cell the kernel finds for it (non-finite
    coordinates count as 0, then the clamp to the grid), numbered with the
    last axis fastest.  With ``unres`` (fused mode) every resolved row's
    key is moved past all cells, so a stable sort puts the unresolved rows
    first, each group in cell order."""
    qfin = torch.where(torch.isfinite(q), q, 0.0)
    coords = cell_coords_of(qfin, grid.origin, grid.inv_cell, grid.res_arr)
    key = _linear(coords, grid.res, range(q.shape[1]))
    if unres is not None:
        key = key + (unres == 0).to(torch.int64) * math.prod(grid.res)
    return key


def grid_round_plain(points, grid: Grid, q, qid, r2: float, k: int, *, out,
                     tests, unres=None, res_round=None, t: int = 0,
                     executed=None, evaluated=None,
                     chunk: int = 2048) -> None:
    """Plain PyTorch version of the grid-round kernel's reference designs,
    same contract.

    ``points`` (N, d) f32, ``q`` (Q, d) f32 and ``qid`` (Q,) int32 on the
    grid's device; ``out`` = (d2 (Q, k) f32, idx (Q, k) i32, found (Q,)
    i32) is written in place for the rows that run; ``tests`` (1,) int64
    is added to.  Fused mode: ``unres`` (Q,) uint8 selects the rows to run
    and is cleared where a row finds >= k; ``res_round`` (Q,) int32 gets
    ``t`` there; ``executed`` (1,) int32 is set to 1 if any row ran.
    ``evaluated`` (1,) int64 is added the distances the sub-grid walk
    computes; the reference designs, which compute one a test, leave it.
    """
    pts_padded, offs, step = _stencil_setup(points, grid, q, chunk)

    def run(r):
        top_d, top_i, fnd, valid = _chunk_candidates(
            pts_padded, grid.buckets, grid.point_cells, grid.origin,
            grid.inv_cell, grid.res_arr, offs, q[r], qid[r], r2,
            table_size=grid.table_size, k=k)
        return top_d, top_i, fnd, valid.sum(dtype=torch.int64), None

    _plain_round(run, step, q, k, out=out, tests=tests, unres=unres,
                 res_round=res_round, t=t, executed=executed)


def _stencil_setup(points, grid: Grid, q, chunk: int):
    """The reference designs' plain rounds: the padded cloud, the stencil,
    and the rows a step (at most ``chunk``, their candidate blocks within
    ``_CAND_ELEMS``)."""
    offs = torch.as_tensor(stencil_offsets(points.shape[1]), device=q.device)
    n_cand = offs.shape[0] * grid.cap
    step = max(1, min(int(chunk), _CAND_ELEMS[q.device.type] // n_cand))
    return _pad_points(points), offs, step


def _plain_round(run, step: int, q, k: int, *, out, tests, unres, res_round,
                 t: int, executed, evaluated=None) -> None:
    """The plain versions' loop over the rows that run, ``step`` at a
    time: ``run(rows)`` gives (d2, idx, found, n_tests, distances computed
    or None), written back with the fused flags."""
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
    for i0 in range(0, rows.numel(), step):
        r = rows[i0:i0 + step]
        top_d, top_i, fnd, n_tests, n_eval = run(r)
        od[r] = top_d
        oi[r] = top_i
        of[r] = fnd
        tests += n_tests
        if evaluated is not None and n_eval is not None:
            evaluated += n_eval
        if unres is not None:
            done = r[fnd >= k]
            res_round[done] = t
            unres[done] = 0


# -- the sub-grid walk --------------------------------------------------------


def _walk_rows(grid: Grid, qr, qi, r2: float, k: int):
    """One step of the plain walk on the rows ``qr`` (ids ``qi``): (d2,
    idx, found, n_tests, distances computed)."""
    sub = grid.sub
    n = grid.n_points
    m, d = qr.shape
    dev = qr.device
    begin, end = walk_ranges(sub, qr)
    lens = (end - begin).reshape(-1)
    if m > 1 and int(lens.sum()) > _CAND_ELEMS[dev.type]:
        # halves of the rows, so that the candidates stay within the budget
        h = m // 2
        lo = _walk_rows(grid, qr[:h], qi[:h], r2, k)
        hi = _walk_rows(grid, qr[h:], qi[h:], r2, k)
        return (*(torch.cat([x, y]) for x, y in zip(lo[:3], hi[:3])),
                lo[3] + hi[3], lo[4] + hi[4])
    seg_row = torch.arange(m, device=dev).repeat_interleave(lens.shape[0] // m)
    row = seg_row.repeat_interleave(lens)
    first = torch.cumsum(lens, 0) - lens
    pos = (begin.reshape(-1).repeat_interleave(lens)
           + torch.arange(row.numel(), device=dev)
           - first.repeat_interleave(lens))
    cand = sub.pts[pos]
    pid = cand[:, 3].contiguous().view(torch.int32)
    qc = qr[row]
    diff = cand[:, 0] - qc[:, 0]
    d2 = diff * diff
    for a in range(1, d):  # the reference's FMA chain
        diff = cand[:, a] - qc[:, a]
        d2 = torch.addcmul(d2, diff, diff)
    # kept: in radius, not the row itself, and in the reference's stencil
    # (its cell in range and within one of the row's on every axis)
    cells = cell_coords_of(torch.where(torch.isfinite(qr), qr, 0.0),
                           grid.origin, grid.inv_cell, grid.res_arr)
    pc = grid.point_cells[pid.to(torch.int64)]
    off = (pc - cells[row]).to(torch.int64)
    kept = ((d2 <= r2) & (pid != qi[row]) & (off.abs() <= 1).all(-1)
            & ((pc >= 0) & (pc < grid.res_arr)).all(-1))
    s = _linear(off + 1, (3,) * d, range(d))
    key = ((d2.view(torch.int32).to(torch.int64) << 32)
           | (s << SUB_INDEX_BITS) | pid.to(torch.int64))[kept]
    row = row[kept]
    found = torch.bincount(row, minlength=m).to(torch.int32)
    # each row's k least keys: sort by key, then stably by row
    key, o = torch.sort(key, stable=True)
    row, o2 = torch.sort(row[o], stable=True)
    key = key[o2]
    rank = (torch.arange(row.numel(), device=dev)
            - (torch.cumsum(found, 0) - found).to(torch.int64)[row])
    take = rank < k
    top_d = torch.full((m, k), math.inf, dtype=torch.float32, device=dev)
    top_i = torch.full((m, k), n, dtype=torch.int32, device=dev)
    top_d[row[take], rank[take]] = (key[take] >> 32).to(torch.int32).view(
        torch.float32)
    top_i[row[take], rank[take]] = (
        key[take] & ((1 << SUB_INDEX_BITS) - 1)).to(torch.int32)
    return top_d, top_i, found, ref_tests(grid, sub, qr).sum(), lens.sum()


def grid_round_subgrid_plain(points, grid: Grid, q, qid, r2: float, k: int,
                             *, out, tests, unres=None, res_round=None,
                             t: int = 0, executed=None, evaluated=None,
                             chunk: int = 2048) -> None:
    """Plain PyTorch version of the kernel's sub-grid walk (same contract
    as ``grid_round_plain``, and the same outputs bitwise where
    ``round_design`` takes the walk): per row, the points of its 3^d
    sub-cells (``walk_ranges``), their d2 as the kernel's FMA chain, kept
    where in radius, not the row itself and in the reference's stencil,
    and the k least by the key (d2 bits, stencil index, index); n_tests
    from the reference's per-cell counts (``ref_tests``).  ``evaluated``
    gets the distances computed.  ``chunk`` rows a step."""
    _plain_round(lambda r: _walk_rows(grid, q[r], qid[r], r2, k),
                 max(1, int(chunk)), q, k, out=out, tests=tests, unres=unres,
                 res_round=res_round, t=t, executed=executed,
                 evaluated=evaluated)


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
    pts_padded, offs, step = _stencil_setup(points, grid, q, chunk)

    def run(r):
        cand, d2, valid, within, live = _chunk_scores(
            pts_padded, grid.buckets, grid.point_cells, grid.origin,
            grid.inv_cell, grid.res_arr, offs, q[r], qid[r], r2,
            table_size=grid.table_size)
        which = _split_of(live, splits, tile).reshape(cand.shape)
        parts = [_topk_within(cand, d2, within & (which == s), k, n)
                 for s in range(splits)]
        merged = merge_partial_topk(
            *(torch.stack([p[j] for p in parts]) for j in range(3)), k, n)
        return (*merged, valid.sum(dtype=torch.int64), None)

    _plain_round(run, step, q, k, out=out, tests=tests, unres=unres,
                 res_round=res_round, t=t, executed=executed)


def _grid_round_cuda(points, grid: Grid, q, qid, r2: float, k: int, *, out,
                     tests, unres=None, res_round=None, t: int = 0,
                     executed=None, evaluated=None, perm=None) -> None:
    """Launch ``csrc/grid_round.cu`` (same contract as the plain version),
    in the design ``round_design`` picks."""
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
        (evaluated, torch.int64, (1,)),
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
    design = round_design(grid, r2, k, unres is not None)
    if design == "walk":
        _launch_walk(grid, q, qid, r2, k, out=out, tests=tests,
                     unres=unres, res_round=res_round, t=t,
                     executed=executed, evaluated=evaluated, perm=perm)
    else:
        _launch(points, grid, q, qid, r2, k, design == "coarse", out=out,
                tests=tests, unres=unres, res_round=res_round, t=t,
                executed=executed)


def _row_order(q, grid, unres, n_active):
    """A launch's row order on the card: the rows sorted stably by their
    ``cell_keys`` in ``grid`` (a ``Grid`` or its ``SubGrid``), folded into
    31 bits (modulo 2^31 - 1: a grid of fewer cells keeps its order), the
    rows that run first in fused mode, where ``n_active`` (one zeroed
    int32, or None) gets their count on the device: no host read.  The
    keys come from one launch of this checkout's extension."""
    keys = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    extension().grid_round_keys(q, grid.origin, grid.inv_cell, grid.res_arr,
                                unres, keys, n_active)
    return torch.argsort(keys, stable=True)


def walk_order(q, grid: Grid, unres=None):
    """The sub-grid walk's row order for ``q`` on the card (``_row_order``
    in ``grid``'s sub-grid, the rows that run first in fused mode), for
    the walked rounds of one search to share: a later round runs a subset
    of the rows, still in sub-cell order.  None on the CPU, whose plain
    walk takes the rows as they are."""
    if q.device.type != "cuda":
        return None
    return _row_order(q, grid.sub, unres, None)


def _launch_walk(grid: Grid, q, qid, r2: float, k: int, *, out, tests,
                 unres=None, res_round=None, t: int = 0, executed=None,
                 evaluated=None, perm=None, ext=None) -> None:
    """One launch of the kernel's sub-grid walk on checked tensors: the
    rows in ``perm`` order (by default ``_row_order`` in the sub-grid,
    resolved rows last in fused mode, on the device), a thread a row at k
    <= 32, a warp above, and a warp or a block a row for the rows with
    more candidates than those take (queued on the device).  The wrapper
    takes the walk by ``round_design``; ``chip_smoke.py`` and the card
    tests call it directly."""
    od, oi, of = out
    sub = grid.sub
    ext = extension() if ext is None else ext
    dev = q.device
    if perm is not None:
        n_active = (None if unres is None
                    else unres.sum(dtype=torch.int32).reshape(1))
    else:
        n_active = (None if unres is None
                    else torch.zeros((1,), dtype=torch.int32, device=dev))
        perm = _row_order(q, sub, unres, n_active)
    # the queues of the rows left to the warp and the block walk
    queue = torch.empty((2, q.shape[0]), dtype=torch.int32, device=dev)
    queued = torch.empty((2,), dtype=torch.int32, device=dev)
    ext.grid_round_walk(
        grid.point_cells, grid.origin, grid.inv_cell, grid.res_arr, q, qid,
        perm, n_active, int(k), float(r2), sub.pts, sub.cell_start, sub.cell_z,
        sub.col_start, sub.origin, sub.inv_cell, sub.res_arr, sub.ref_keys,
        sub.ref_cum, od, oi, of, unres, res_round, int(t), tests, evaluated,
        executed, queue, queued,
    )
    count_launch("grid_round", wide=k > 32)


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
        if unres is not None:
            n_active = torch.zeros((1,), dtype=torch.int32, device=q.device)
        perm = _row_order(q, grid, unres, n_active)
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
               chunk: int = 2048, perm=None, **kw) -> None:
    """One grid round with in-place outputs (see ``grid_round_plain`` for
    the contract): the CUDA kernel for tensors on the card, the plain
    version of the design ``round_design`` picks (``chunk`` rows per step
    at most) for tensors on the CPU.  ``perm``: the walk's row order
    (``walk_order``), which the walked rounds of one search share; by
    default a walk on the card sorts its own rows."""
    if q.device.type == "cuda":
        _grid_round_cuda(points, grid, q, qid, r2, k, perm=perm, **kw)
    elif round_design(grid, r2, k, kw.get("unres") is not None) == "walk":
        grid_round_subgrid_plain(points, grid, q, qid, r2, k, chunk=chunk,
                                 **kw)
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
