"""Sharded-grid distributed TrueKNN (port of ``repro.core.distributed_grid``)
— the paper's pruning on a device mesh.

The dense streaming engine (``distributed.py``) is exact in one pass but
touches every (query, point-shard) pair: per-round cost Q x N/P.  This
module keeps the *candidate-side* pruning too: every point shard gets its
own spatial hash grid (stacked into arrays with a leading shard dim), a
fixed-radius round runs per shard through the grid stencil
(``core.fixed_radius.grid_round``: the ``grid_round`` kernel on the card),
partial in-radius top-k lists merge across shards with the hypercube
exchange, and the TrueKNN retirement/radius-doubling loop drives rounds
from the host.

Stacking contract: all shards share (table_size, cap) = max over shards
(from the sizing probe alone, in a first pass), so the stacked arrays are
rectangular; the per-shard origin/res/cell arrays ride along, so each
shard's geometry is its own.  Candidate tests are counted in int64 (the
reference sums float32, exact only below 2^24 a chunk).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.ops import as_f32
from .distributed import (
    DeviceMesh,
    _gather_slices,
    _host_tensor,
    _layout,
    hypercube_merge,
)
from .fixed_radius import grid_round
from .grid import Grid, GridCapError, build_grid, grid_shape
from .sampling import sample_start_radius

__all__ = ["shard_points", "build_stacked_grids", "make_grid_round",
           "distributed_trueknn_grid"]


def shard_points(points: np.ndarray, n_shards: int):
    """Split (N, d) row-wise into (n_shards, Nl, d) with +inf padding rows.

    Returns (stacked, n_valid per shard).  Global index of shard s row i is
    s * Nl + i.
    """
    pts = np.asarray(points, np.float32)
    n, d = pts.shape
    nl = -(-n // n_shards)
    out = np.full((n_shards, nl, d), np.inf, np.float32)
    n_valid = np.zeros((n_shards,), np.int64)
    for s in range(n_shards):
        chunk = pts[s * nl : (s + 1) * nl]
        out[s, : len(chunk)] = chunk
        n_valid[s] = len(chunk)
    return out, n_valid


def _device_bytes(dev: torch.device) -> int:
    """Bytes free on ``dev``: the card's free memory and what PyTorch's
    allocator holds unused; the host's RAM."""
    if dev.type == "cuda":
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        return torch.cuda.mem_get_info(dev)[0] + cached
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _check_stacked_bytes(reqs, table_size: int, cap: int, dev) -> None:
    """Raise ``MemoryError`` before allocating stacked buckets that cannot
    fit: every shard's (table_size, cap) int32 table, built and then
    stacked (two copies)."""
    need = 2 * len(reqs) * table_size * cap * 4
    free = _device_bytes(dev)
    if need > free:
        raise MemoryError(
            f"stacked grids need {need / 2**30:.1f} GiB of buckets at the "
            f"shared shape (table {table_size}, cap {cap}), {free / 2**30:.1f}"
            f" GiB free on {dev}: the shards ask for (table, cap) "
            f"{sorted(set(reqs))}, and the shared shape is the largest of "
            f"each; the stacked-grid contract needs shards of one shape "
            f"(ROADMAP section 3)"
        )


def build_stacked_grids(pts_shards: np.ndarray, n_valid: np.ndarray,
                        radius: float, *, device="cuda"):
    """Per-shard hash grids at a common (table_size, cap) shape, binned on
    ``device``.

    Returns (dict of stacked tensors with a leading shard dim — buckets,
    point_cells, origin, inv_cell, res — plus ``cell_size``, a (P, d)
    array; table_size; cap).
    """
    dev = resolve_device(device)
    n_shards = pts_shards.shape[0]
    reqs = [grid_shape(pts_shards[s], radius, n_valid=int(n_valid[s]))
            for s in range(n_shards)]
    table_size = max(t for t, _ in reqs)
    cap = max(c for _, c in reqs)
    shards_t = torch.as_tensor(pts_shards, device=dev)
    # second pass at the common shape (cap may grow at the shared H; retry)
    while True:
        _check_stacked_bytes(reqs, table_size, cap, dev)
        try:
            grids = [
                build_grid(
                    pts_shards[s],
                    radius,
                    device_points=shards_t[s],
                    n_valid=int(n_valid[s]),
                    force_table_size=table_size,
                    force_cap=cap,
                )
                for s in range(n_shards)
            ]
            break
        except GridCapError:
            cap *= 2
    return {
        "buckets": torch.stack([g.buckets for g in grids]),
        "point_cells": torch.stack([g.point_cells for g in grids]),
        "origin": torch.stack([g.origin for g in grids]),
        "inv_cell": torch.stack([g.inv_cell for g in grids]),
        "res": torch.stack([g.res_arr for g in grids]),
        "cell_size": np.stack([g.cell_size for g in grids]),
    }, table_size, cap


def _shard_grid(grids: dict, s: int, table_size: int, nl: int, dev) -> Grid:
    """Shard ``s``'s slice of the stacked grids as a ``Grid`` on ``dev``."""
    res_arr = grids["res"][s].to(dev)
    return Grid(
        buckets=grids["buckets"][s].to(dev),
        point_cells=grids["point_cells"][s].to(dev),
        origin=grids["origin"][s].to(dev),
        inv_cell=grids["inv_cell"][s].to(dev),
        res=tuple(int(r) for r in res_arr.tolist()),
        res_arr=res_arr,
        table_size=int(table_size),
        cap=int(grids["buckets"].shape[2]),
        n_points=nl,
        cell_size=grids["cell_size"][s],
    )


def make_grid_round(mesh: DeviceMesh, k: int, table_size: int, *,
                    chunk: int = 1024, point_axis: str = "model"):
    """Fixed-radius round over stacked per-shard grids, per mesh position.

    fn(pts (P, Nl+1, d) with a sentinel row per shard, grids dict,
       queries (Q, d), query_ids (Q,), r2) ->
       (d2 (Q, k), idx (Q, k) global, found (Q,) tensors on the mesh's
        first device, tests: int over every position)
    """
    positions, p_size, bsz = _layout(mesh, point_axis)

    def fn(pts, grids, queries, query_ids, r2):
        nl = pts.shape[1] - 1  # sentinel row appended upstream
        n_global = nl * p_size
        q = _host_tensor(queries, torch.float32)
        qid = _host_tensor(query_ids, torch.int64)
        n_q = q.shape[0]
        if n_q % bsz:
            raise ValueError(f"{n_q} queries do not split into {bsz} slices")
        qs = n_q // bsz
        q_chunk = min(chunk, max(qs, 1))
        lists, tests_total, views = {}, 0, {}
        for pos, shard, b in positions:
            dev = mesh.devices[pos]
            if (shard, dev) not in views:
                views[shard, dev] = (
                    as_f32(pts[shard, :nl], dev),
                    _shard_grid(grids, shard, table_size, nl, dev),
                )
            pts_l, grid = views[shard, dev]
            q_l = as_f32(q[b * qs:(b + 1) * qs], dev)
            qid_g = qid[b * qs:(b + 1) * qs]
            lo = shard * nl
            qid_l = torch.where((qid_g >= lo) & (qid_g < lo + nl), qid_g - lo,
                                nl).to(device=dev, dtype=torch.int32)
            out = (
                torch.empty((qs, k), dtype=torch.float32, device=dev),
                torch.empty((qs, k), dtype=torch.int32, device=dev),
                torch.empty((qs,), dtype=torch.int32, device=dev),
            )
            tests = torch.zeros((1,), dtype=torch.int64, device=dev)
            grid_round(pts_l, grid, q_l, qid_l.contiguous(), float(r2), k,
                       out=out, tests=tests, chunk=q_chunk)
            d2, idx, found = out
            idx = torch.where(idx < nl, idx + lo, n_global).to(torch.int32)
            lists[pos] = (d2, idx, found)
            tests_total += int(tests.item())
        lists = hypercube_merge(lists, mesh, point_axis, int(k))
        return (*_gather_slices(lists, positions, bsz, mesh.first_device),
                tests_total)

    return fn


def distributed_trueknn_grid(
    points,
    k: int,
    mesh: DeviceMesh,
    *,
    queries=None,
    start_radius=None,
    growth: float = 2.0,
    max_rounds: int = 40,
    point_axis: str = "model",
):
    """Full TrueKNN (Alg. 3) over mesh-sharded points with per-shard grids.

    Returns (dists (Q,k), idxs (Q,k) global, stats dict).  The stats hold
    per-round radius, queries, resolved, tests, cap and table, the total
    tests and the start radius, and ``grid_build_seconds``, the host-side
    time spent building the rounds' stacked grids.
    """
    pts = np.asarray(points, np.float32)
    n, d = pts.shape
    p_size = mesh.shape[point_axis]
    shards, n_valid = shard_points(pts, p_size)
    # sentinel +inf row per shard (gathers of bucket-pad index nl land here)
    shards_pad = np.concatenate(
        [shards, np.full((p_size, 1, d), np.inf, np.float32)], axis=1
    )
    dev = mesh.first_device

    if queries is None:
        q_all = pts
        # global index of point j is (j // nl) * nl + j % nl == j
        qid_all = np.arange(n, dtype=np.int32)
    else:
        q_all = np.asarray(queries, np.float32)
        qid_all = np.full((q_all.shape[0],), -1, np.int32)
    q_total = q_all.shape[0]
    r = float(start_radius) if start_radius else sample_start_radius(
        torch.as_tensor(pts, device=dev))
    r0 = r

    out_d = np.full((q_total, k), np.inf, np.float32)
    out_i = np.full((q_total, k), n, np.int32)
    alive = np.arange(q_total)
    _, _, bsz = _layout(mesh, point_axis)
    pts_t = torch.as_tensor(shards_pad, device=dev)

    stats = {"rounds": [], "total_tests": 0, "start_radius": r0,
             "grid_build_seconds": 0.0}
    rounds = 0
    while alive.size and rounds < max_rounds:
        t0 = time.perf_counter()
        grids, table_size, cap = build_stacked_grids(shards, n_valid, r,
                                                     device=dev)
        stats["grid_build_seconds"] += time.perf_counter() - t0
        fn = make_grid_round(mesh, k, table_size, point_axis=point_axis)

        m = alive.size
        m_pad = max(bsz, 1 << max(0, (m - 1).bit_length()))
        q = np.full((m_pad, d), np.inf, np.float32)
        q[:m] = q_all[alive]
        qid = np.full((m_pad,), -1, np.int32)
        qid[:m] = qid_all[alive]
        d2, idx, found, tests = fn(pts_t, grids, q, qid,
                                   float(np.float32(r) ** 2))
        d2 = d2.cpu().numpy()[:m]
        idx = idx.cpu().numpy()[:m]
        found = found.cpu().numpy()[:m]
        stats["total_tests"] += tests
        resolved = found >= k
        done = alive[resolved]
        out_d[done] = d2[resolved]
        out_i[done] = idx[resolved]
        alive = alive[~resolved]
        stats["rounds"].append(
            {"radius": r, "queries": m, "resolved": int(resolved.sum()),
             "tests": tests, "cap": cap, "table": table_size}
        )
        r *= growth
        rounds += 1

    if alive.size:
        raise RuntimeError(f"{alive.size} unresolved after {max_rounds} rounds")
    # padded-shard global idx s * Nl + i equals the dataset idx for every
    # real point (padding rows are never binned, so idx < n)
    return np.sqrt(np.maximum(out_d, 0)), out_i, stats

