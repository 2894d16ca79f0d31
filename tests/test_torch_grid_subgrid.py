"""The grid round's sub-grid walk against the reference's designs.

A grid the sizing probe coarsened carries a cap-free ``SubGrid``, and a
round on it walks that (``round_design``).  ``grid_round_subgrid_plain``
must give ``grid_round_plain``'s d2, idx, found, n_tests and, fused,
unres, res_round and executed bitwise, and the JAX reference's
``fixed_radius_round`` answers on the same grid.  The grids here are
coarsened by a small ``max_bucket_elems`` to a few cells an axis, so that
a reference stencil misses some cells; the clouds are LiDAR-like,
clustered 2-D, and a quantised one whose every point is there three
times, so that equal distances are common.  The CUDA walk is held
against the plain walk and the coarse design on the card only (the JAX
package is imported inside the CPU tests alone).
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import grid_from_numpy
from repro_torch.core.datasets import make_dataset
from repro_torch.core.fixed_radius import (
    WALK_COST,
    WALK_MAX_K,
    coarse_design,
    grid_round,
    grid_round_plain,
    grid_round_subgrid_plain,
    round_design,
)
from repro_torch.core.grid import build_grid, build_subgrid

torch.set_num_threads(1)

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)

#: cloud -> (points, radius as a share of the extent, max_bucket_elems)
#: that coarsen the grid to at most a few cells an axis
KINDS = ("lidar_like", "clustered", "ties")


def _cloud(kind):
    if kind == "lidar_like":
        return make_dataset("kitti", 3000, seed=11), 1 / 12, 1 << 15
    if kind == "clustered":
        return make_dataset("porto", 1500, seed=12), 1 / 50, 1 << 13
    base = np.round(make_dataset("uniform", 500, seed=13) * 16) / 16
    return np.concatenate([base] * 3).astype(np.float32), 1 / 8, 1 << 14


def _grid(kind):
    """(points, radius, port grid with its sub-grid)."""
    pts, frac, mbe = _cloud(kind)
    r = float((pts.max(0) - pts.min(0)).max()) * frac
    g = build_grid(pts, r, max_bucket_elems=mbe)
    assert g.sub is not None and max(g.res) >= 3, g.res
    return pts, r, g


def _rows(pts, rng, m=160):
    """(queries, ids): self rows, rows near the cloud (foreign), rows
    outside its box and rows with a non-finite coordinate."""
    n, d = pts.shape
    own = rng.choice(n, m, replace=False)
    near = pts[rng.choice(n, 40, replace=False)] + rng.normal(
        scale=1e-3, size=(40, d)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    out = np.stack([lo - 5.0, hi + 5.0, lo - 1e-3]).astype(np.float32)
    bad = np.tile(pts[:1], (4, 1))
    bad[0, 0] = np.nan
    bad[1, d - 1] = np.inf
    bad[2, :] = np.nan
    bad[3, 0] = -np.inf
    q = np.concatenate([pts[own], near, out, bad]).astype(np.float32)
    qid = np.concatenate([own, np.full(len(q) - m, n)]).astype(np.int32)
    return q, qid


def _state(m, k, unres=None):
    out = (torch.full((m, k), -1.0), torch.full((m, k), -1, dtype=torch.int32),
           torch.full((m,), -1, dtype=torch.int32))
    kw = dict(tests=torch.zeros(1, dtype=torch.int64))
    if unres is not None:
        kw.update(unres=unres.clone(),
                  res_round=torch.full((m,), -1, dtype=torch.int32), t=3,
                  executed=torch.zeros(1, dtype=torch.int32))
    return out, kw


def _flat(out, kw):
    return list(out) + [kw[x] for x in ("tests", "unres", "res_round",
                                        "executed") if x in kw]


NAMES = ("d2", "idx", "found", "n_tests", "unres", "res_round", "executed")


def _hold(pts, g, q, qid, r, k, unres=None):
    """The plain walk against ``grid_round_plain`` on the same rows, every
    output bitwise; returns the walk's distances computed."""
    p = torch.from_numpy(pts)
    r2 = float(np.float32(r) ** 2)
    assert round_design(g, r2, k, True) == "walk"
    out, kw = _state(len(q), k, unres)
    grid_round_plain(p, g, q, qid, r2, k, out=out, **kw)
    want = _flat(out, kw)
    out, kw = _state(len(q), k, unres)
    evaluated = torch.zeros(1, dtype=torch.int64)
    grid_round_subgrid_plain(p, g, q, qid, r2, k, out=out,
                             evaluated=evaluated, **kw)
    for name, x, y in zip(NAMES, _flat(out, kw), want):
        assert torch.equal(x, y), name
    return int(evaluated.item()), int(want[3].item())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [8, 32, 50, 64])
@pytest.mark.parametrize("fused", [False, True])
def test_walk_matches_plain_bitwise(kind, k, fused):
    """d2, idx, found, n_tests and the fused flags equal the reference
    design's, with self, foreign, outside and non-finite rows; the walk
    computes fewer distances than the reference tests."""
    pts, r, g = _grid(kind)
    rng = np.random.default_rng(k + 7 * fused + len(kind))
    q, qid = _rows(pts, rng)
    unres = (torch.from_numpy((rng.random(len(q)) < 0.7).astype(np.uint8))
             if fused else None)
    evaluated, tests = _hold(pts, g, torch.from_numpy(q),
                             torch.from_numpy(qid), r, k, unres)
    assert 0 < evaluated < tests


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [8, 50])
def test_walk_matches_the_reference(kind, k):
    """The JAX reference's round on the same grid (its arrays, with the
    port's sub-grid attached): d2, idx, found and n_tests."""
    from repro.core.fixed_radius import fixed_radius_round as jax_round
    from repro.core.grid import build_grid as jax_build_grid

    pts, frac, mbe = _cloud(kind)
    r = float((pts.max(0) - pts.min(0)).max()) * frac
    jg = jax_build_grid(pts, r, max_bucket_elems=mbe)
    g = grid_from_numpy(
        buckets=np.asarray(jg.buckets), point_cells=np.asarray(jg.point_cells),
        origin=np.asarray(jg.origin), inv_cell=np.asarray(jg.inv_cell),
        res=tuple(jg.res), table_size=jg.table_size, cap=jg.cap,
        n_points=jg.n_points, cell_size=np.asarray(jg.cell_size),
        device="cpu")
    g = dataclasses.replace(g, sub=build_subgrid(g, torch.from_numpy(pts), r))
    q, qid = _rows(pts, np.random.default_rng(k))
    want = jax_round(pts, jg, q, qid, r, k, chunk=64)
    out, kw = _state(len(q), k)
    grid_round_subgrid_plain(torch.from_numpy(pts), g, torch.from_numpy(q),
                             torch.from_numpy(qid), float(np.float32(r) ** 2),
                             k, out=out, **kw)
    for x, y in zip(out, want[:3]):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert kw["tests"].item() == want[3]


@pytest.mark.parametrize("fused", [False, True])
def test_non_finite_points_are_never_candidates(fused):
    """Points with a NaN or an infinite coordinate stay out of the
    sub-grid; the outputs equal the reference design's, n_tests included
    (an axis with such a point has one cell, so the probe can coarsen
    only the other one)."""
    pts, r, _ = _grid("clustered")
    pts = pts.copy()
    pts[5, 1] = np.nan
    pts[17, 1] = np.inf
    pts[40, 1] = -np.inf
    _, frac, mbe = _cloud("clustered")
    g = build_grid(pts, r, max_bucket_elems=mbe)
    assert g.sub is not None
    assert g.sub.pts.shape[0] == len(pts) - 3
    rng = np.random.default_rng(3)
    q, qid = _rows(pts[np.isfinite(pts).all(1)], rng)
    qid = np.where(qid < len(pts) - 3, qid, len(pts)).astype(np.int32)
    unres = torch.ones(len(q), dtype=torch.uint8) if fused else None
    _hold(pts, g, torch.from_numpy(q), torch.from_numpy(qid), r, 8, unres)


@pytest.mark.parametrize("center", [1000.0, -1000.0, 999.5])
@pytest.mark.parametrize("ulps", [0, 1, 3])
def test_points_at_the_radius_across_sub_cell_edges(center, ulps):
    """Queries on sub-cell edges at coordinates near +-1e3 (where one
    float32 ulp is 6.1e-5), and points at r * (1 +- a few ulp) from them
    along each axis and the diagonals: the walk keeps every point the
    reference's stencil holds in radius."""
    rng = np.random.default_rng(int(abs(center)) + ulps)
    r = np.float32(0.37)
    base = (center + rng.uniform(-20, 20, size=(1500, 3))).astype(np.float32)
    g0 = build_grid(base, float(r), max_bucket_elems=1 << 13)
    sub = g0.sub
    assert sub is not None
    # queries on the sub-grid's cell edges: lo + j * side, a float32 step on
    # either side of it
    side = 1.0 / sub.inv_cell.numpy().astype(np.float64)
    lo = sub.origin.numpy()
    qs = []
    for j in (3, 17, 40):
        e = (lo + j * side).astype(np.float32)
        for step in (-1, 0, 1):
            qs.append(np.nextafter(e, np.float32(np.inf) * step)
                      if step else e)
    qs = np.asarray(qs, np.float32)
    # points at r * (1 +- ulps ulp) along each axis and the diagonals
    scale = np.float32(r) * np.float32(1.0 + ulps * 2.0 ** -23)
    dirs = np.concatenate([np.eye(3), -np.eye(3),
                           np.array([[1, 1, 0], [1, -1, 1], [-1, -1, -1]])
                           / np.sqrt([[2], [3], [3]])]).astype(np.float32)
    ring = [qs + np.float32(sign) * scale * dv
            for dv in dirs for sign in (1, -1)]
    ring += [qs + (scale * np.float32(1 - 2.0 ** -22)) * dv for dv in dirs]
    pts = np.concatenate([base] + ring).astype(np.float32)
    g = build_grid(pts, float(r), max_bucket_elems=1 << 13)
    assert g.sub is not None
    qid = np.full(len(qs), len(pts), np.int32)
    _hold(pts, g, torch.from_numpy(qs), torch.from_numpy(qid), float(r), 8)


def test_the_rule_reads_the_grid():
    """A coarsened grid walks in fused mode; one at its natural
    resolution, one under a forced shape, a radius past the sub-grid's
    cover and a list past ``WALK_MAX_K`` take the reference designs; on the
    CPU ``grid_round`` then runs the plain walk, whose outputs are the
    reference design's."""
    pts, r, g = _grid("clustered")
    r2 = float(np.float32(r) ** 2)
    assert round_design(g, r2, 8, True) == "walk"
    assert round_design(g, r2, WALK_MAX_K, True) == "walk"
    assert round_design(g, r2, WALK_MAX_K + 1, True) != "walk"
    assert round_design(g, g.sub.r2_cover * 1.001, 8, True) != "walk"
    natural = build_grid(pts, r)
    assert natural.sub is None and round_design(natural, r2, 8, True) != "walk"
    forced = build_grid(pts, r, max_bucket_elems=1 << 13,
                        force_table_size=g.table_size, force_cap=4096)
    assert forced.sub is None
    q, qid = _rows(pts, np.random.default_rng(1))
    q, qid = torch.from_numpy(q), torch.from_numpy(qid)
    for fused in (False, True):
        unres = torch.ones(len(q), dtype=torch.uint8) if fused else None
        out, kw = _state(len(q), 8, unres)
        ev = torch.zeros(1, dtype=torch.int64)
        grid_round(torch.from_numpy(pts), g, q, qid, r2, 8, out=out,
                   evaluated=ev, **kw)
        got = _flat(out, kw)
        out, kw = _state(len(q), 8, unres)
        grid_round_plain(torch.from_numpy(pts), g, q, qid, r2, 8, out=out,
                         **kw)
        for name, x, y in zip(NAMES, got, _flat(out, kw)):
            assert torch.equal(x, y), name
        assert 0 < ev.item() < kw["tests"].item()


@pytest.mark.parametrize("kind", KINDS)
def test_every_row_rounds_walk_where_the_estimate_says(kind):
    """Outside fused mode a round walks where ``WALK_COST`` times the
    sub-grid's distances a row is at most the reference's tests a row;
    the two estimates are the plain walk's means on the sample of the
    cloud they were made on."""
    pts, r, g = _grid(kind)
    r2 = float(np.float32(r) ** 2)
    sub = g.sub
    ref = "coarse" if coarse_design(g) else "fine"
    cheap = WALK_COST[ref] * sub.walk_per_row <= sub.tests_per_row
    assert round_design(g, r2, 8) == ("walk" if cheap else ref)
    m = len(pts)
    rows = np.linspace(0, m - 1, min(m, 1024)).astype(np.int64)
    q = torch.from_numpy(pts[rows])
    out, kw = _state(len(q), 8)
    ev = torch.zeros(1, dtype=torch.int64)
    grid_round_subgrid_plain(torch.from_numpy(pts), g, q,
                             torch.from_numpy(rows.astype(np.int32)), r2, 8,
                             out=out, evaluated=ev, **kw)
    assert sub.walk_per_row == ev.item() / len(q)
    assert sub.tests_per_row == kw["tests"].item() / len(q)
    for walk, tests in ((1.0, WALK_COST[ref]), (1.0, WALK_COST[ref] * 0.99)):
        est = dataclasses.replace(g, sub=dataclasses.replace(
            sub, walk_per_row=walk, tests_per_row=tests))
        assert round_design(est, r2, 8) == (
            "walk" if tests >= WALK_COST[ref] else ref)
        assert round_design(est, r2, 8, True) == "walk"


def _no_walk(monkeypatch):
    """Every round takes the reference designs, as before the walk."""
    from repro_torch.core import fixed_radius, fused_loop

    real = fixed_radius.round_design

    def reference(grid, r2, k, fused=False):
        design = real(grid, r2, k, fused)
        if design != "walk":
            return design
        return "coarse" if fixed_radius.coarse_design(grid) else "fine"

    monkeypatch.setattr(fixed_radius, "round_design", reference)
    monkeypatch.setattr(fused_loop, "round_design", reference)


def test_trueknn_search_walks_and_counts(monkeypatch):
    """A cloud with a pile of duplicate points makes the probe coarsen at
    the default table bound, so the fused search walks: answers, found,
    n_tests and rounds equal the search without the walk, and the
    counters say how many rounds walked and how many distances ran."""
    from repro_torch import KnnSpec, build_index

    rng = np.random.default_rng(5)
    spread = make_dataset("kitti", 2048, seed=5)
    pile = np.repeat(spread[:1], 8192, 0)
    pts = np.concatenate([spread, pile]).astype(np.float32)
    q = (spread[rng.choice(2048, 16, replace=False)]
         + rng.normal(scale=0.05, size=(16, 3))).astype(np.float32)
    got = build_index(pts, backend="trueknn", device="cpu").query(
        q, KnnSpec(8))
    with monkeypatch.context() as m:
        _no_walk(m)
        want = build_index(pts, backend="trueknn", device="cpu").query(
            q, KnnSpec(8))
    for key in ("dists", "idxs", "found"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert got.n_tests == want.n_tests
    assert ([(s.radius, s.n_queries, s.n_resolved, s.n_tests)
             for s in got.rounds]
            == [(s.radius, s.n_queries, s.n_resolved, s.n_tests)
                for s in want.rounds])
    assert got.timings["subgrid_rounds"] > 0
    assert want.timings["subgrid_rounds"] == 0
    assert want.timings["d2_evaluated"] == want.n_tests
    assert 0 < got.timings["d2_evaluated"] < got.n_tests


# -- on the card: the CUDA walk against the plain walk and the coarse design


def _bench_cloud(config):
    """A benchmark configuration's cloud and k (knnbench's frozen
    generators, from the repository's root)."""
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import json

    from knnbench.datagen import make_cloud

    cfg = json.loads((root / "knnbench" / "configs"
                      / f"{config}.json").read_text())
    return make_cloud(cfg), int(cfg["k"])


@needs_card
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_row_order_is_the_cell_keys_sort(fused):
    """The launches' row order from one kernel: the stable sort of
    ``cell_keys`` in the grid and in its sub-grid (non-finite and outside
    rows included; grids of fewer than 2^31 - 1 cells), the resolved rows
    last in their own order, and the count of the rows that run."""
    from repro_torch.core.fixed_radius import _row_order, cell_keys

    dev = torch.device("cuda")
    pts, r, g = _grid("lidar_like")
    g = build_grid(pts, r, device_points=torch.from_numpy(pts).to(dev),
                   max_bucket_elems=_cloud("lidar_like")[2])
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_rows(pts, rng)[0]).to(dev)
    unres = (torch.from_numpy((rng.random(len(q)) < 0.6).astype(np.uint8))
             .to(dev) if fused else None)
    for cells in (g, g.sub):
        n_active = (torch.zeros(1, dtype=torch.int32, device=dev)
                    if fused else None)
        perm = _row_order(q, cells, unres, n_active)
        key = cell_keys(q, cells)
        if fused:
            key = torch.where(unres == 0, 2**31 - 1, key)
        want = torch.argsort(key, stable=True)
        assert torch.equal(perm, want)
        if fused:
            assert n_active.item() == int(unres.sum())


CELLS = [("kitti_map_1m", False), ("kitti_map_1m_draw1", False),
         ("porto_gps_1m", True), ("kitti_map_1m_sor", True)]


@needs_card
@pytest.mark.parametrize("config,self_rows", CELLS)
def test_cuda_walk_matches_plain_and_coarse(config, self_rows):
    """On a cell's 2^20 cloud, every scheduled round that walks, on 2048
    rows (the cell's own kind: self rows or a scan's foreign rows) at the
    cell's k, non-fused and fused: the CUDA walk, the plain walk on the
    card and the kernel's coarse design give equal outputs bitwise, and
    the walk's and the plain walk's distance counts agree."""
    from repro_torch import build_index
    from repro_torch.core.fixed_radius import _launch, _launch_walk
    from repro_torch.core.fused_loop import build_schedule

    dev = torch.device("cuda")
    cloud, k = _bench_cloud(config)
    index = build_index(cloud, backend="trueknn", device="cuda")
    r0, _ = index._start_radius(None)
    index._set_anchor(r0)
    sched = build_schedule(index, r0)
    pts = index._pts_t
    n = pts.shape[0]
    rng = np.random.default_rng(len(config))
    walked = 0
    for t, g in enumerate(sched.grids):
        r2 = float(np.float32(sched.radii[t]) ** 2)
        if round_design(g, r2, k, True) != "walk":
            continue
        walked += 1
        rows = torch.from_numpy(rng.choice(n, 2048, replace=False)).to(dev)
        q = pts[rows].contiguous()
        qid = rows.to(torch.int32)
        if not self_rows:
            q = (q + 0.03).contiguous()
            qid = torch.full_like(qid, n)
        unres = (torch.from_numpy((rng.random(2048) < 0.7).astype(np.uint8))
                 .to(dev))
        for fused in (None, unres):
            got = {}
            for name in ("walk", "plain", "coarse"):
                out = (torch.full((2048, k), -1.0, device=dev),
                       torch.full((2048, k), -1, dtype=torch.int32,
                                  device=dev),
                       torch.full((2048,), -1, dtype=torch.int32, device=dev))
                kw = dict(tests=torch.zeros(1, dtype=torch.int64, device=dev))
                if fused is not None:
                    kw.update(unres=fused.clone(), t=2,
                              res_round=torch.full((2048,), -1,
                                                   dtype=torch.int32,
                                                   device=dev),
                              executed=torch.zeros(1, dtype=torch.int32,
                                                   device=dev))
                ev = torch.zeros(1, dtype=torch.int64, device=dev)
                if name == "walk":
                    _launch_walk(g, q, qid, r2, k, out=out, evaluated=ev,
                                 **kw)
                elif name == "plain":
                    grid_round_subgrid_plain(pts, g, q, qid, r2, k, out=out,
                                             evaluated=ev, **kw)
                else:
                    _launch(pts, g, q, qid, r2, k, True, out=out, **kw)
                got[name] = (list(out) + [kw[x] for x in (
                    "tests", "unres", "res_round", "executed") if x in kw],
                    ev.item())
            for name in ("plain", "coarse"):
                for what, x, y in zip(NAMES, got["walk"][0], got[name][0]):
                    assert torch.equal(x, y), (t, name, what)
            assert got["walk"][1] == got["plain"][1] > 0
    assert walked > 0


@needs_card
@pytest.mark.parametrize("config,self_rows", CELLS)
def test_cuda_batches_equal_the_reference_designs(config, self_rows,
                                                  monkeypatch):
    """A cell's first two batches (a 2^17-row scan, or the whole cloud's
    self query) through the fused search with the walk and with every
    round on the reference designs: answers, found, n_tests and rounds
    bitwise equal; the walk computes fewer distances."""
    from repro_torch import KnnSpec, build_index

    cloud, k = _bench_cloud(config)
    rng = np.random.default_rng(2)
    qs = None
    if not self_rows:
        rows = rng.choice(len(cloud), 1 << 17, replace=False)
        qs = (cloud[rows] + rng.normal(scale=0.05, size=(1 << 17, 3))
              ).astype(np.float32)

    def batches():
        index = build_index(cloud, backend="trueknn", device="cuda")
        return [index.query(qs, KnnSpec(k)) for _ in range(2)]

    got = batches()
    with monkeypatch.context() as m:
        _no_walk(m)
        want = batches()
    for a, b in zip(got, want):
        for key in ("dists", "idxs", "found"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        assert a.n_tests == b.n_tests
        assert ([(s.radius, s.n_queries, s.n_resolved, s.n_tests)
                 for s in a.rounds]
                == [(s.radius, s.n_queries, s.n_resolved, s.n_tests)
                    for s in b.rounds])
        assert a.timings["subgrid_rounds"] > 0
        assert a.timings["d2_evaluated"] < b.timings["d2_evaluated"]
