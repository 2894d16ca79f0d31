"""The coarse grid round split S ways and merged, in plain PyTorch.

``grid_round_split_plain`` is the kernel's split and merge in its order:
each row's stencil walk cut into contiguous shares of slot tiles, a
partial k-best list and in-radius count a share, the lists merged with
the earlier split first on equal d2.  For every S it must give
``grid_round_plain``'s d2, idx, found, n_tests and fused flags bitwise, and
the JAX reference's ``fixed_radius_round`` answers.  Small tiles (a few
slots) make the splits cut every bucket at these sizes; the clouds are a
tie-heavy one (every point three times, so equal distances fall in
different splits) and a collapsed grid (every row tests most points).
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import grid_from_numpy
from repro_torch.core.datasets import make_dataset
from repro_torch.core.fixed_radius import (
    _split_of,
    grid_round_plain,
    grid_round_split_plain,
)

torch.set_num_threads(1)

SPLITS = (1, 2, 3, 8)
TILE = 4  # slots a tile: many tiles a bucket at these sizes


def _cloud(kind):
    """(points, radius): three copies of 100 points on a fine grid, or 300
    points on a grid of two cells an axis at most."""
    base = make_dataset("kitti", 300, seed=7)
    ext = float((base.max(0) - base.min(0)).max())
    if kind == "ties":
        return np.concatenate([base[:100]] * 3), ext / 8
    return base, ext / 2.5


def _grids(pts, r):
    from repro.core.grid import build_grid as jax_build_grid

    jg = jax_build_grid(pts, r)
    arrays = dict(
        buckets=np.asarray(jg.buckets), point_cells=np.asarray(jg.point_cells),
        origin=np.asarray(jg.origin), inv_cell=np.asarray(jg.inv_cell),
        res=tuple(jg.res), table_size=jg.table_size, cap=jg.cap,
        n_points=jg.n_points, cell_size=np.asarray(jg.cell_size))
    return jg, grid_from_numpy(device="cpu", **arrays)


def _state(m, k, fused, active):
    out = (torch.full((m, k), -1.0), torch.full((m, k), -1, dtype=torch.int32),
           torch.full((m,), -1, dtype=torch.int32))
    kw = dict(tests=torch.zeros(1, dtype=torch.int64))
    if fused:
        unres = torch.zeros(m, dtype=torch.uint8)
        unres[active] = 1
        kw.update(unres=unres, res_round=torch.full((m,), -1, dtype=torch.int32),
                  t=3, executed=torch.zeros(1, dtype=torch.int32))
    return out, kw


def _flat(out, kw):
    return list(out) + [kw[x] for x in ("tests", "unres", "res_round",
                                        "executed") if x in kw]


@pytest.mark.parametrize("kind", ["ties", "collapsed"])
@pytest.mark.parametrize("k", [8, 32, 64, 100])
@pytest.mark.parametrize("n_active", [1, 5, 206])
@pytest.mark.parametrize("fused", [False, True])
def test_split_round_matches_plain_bitwise(kind, k, n_active, fused):
    """Every S gives the unsplit round's outputs bitwise: d2, idx, found,
    n_tests and, fused, unres, res_round and executed (rows outside the
    mask untouched)."""
    pts, r = _cloud(kind)
    _, g = _grids(pts, r)
    p = torch.from_numpy(pts)
    rng = np.random.default_rng(k + n_active)
    m = 220
    rows = rng.choice(len(pts), m, replace=False)
    q = p[torch.from_numpy(rows)].contiguous()
    qid = torch.from_numpy(rows.astype(np.int32))
    if not fused:  # the rows that run are all of a call
        m = n_active
        q, qid = q[:m].contiguous(), qid[:m].contiguous()
    # the rows that run sit at the end of the order
    active = torch.arange(m - n_active, m)
    r2 = float(np.float32(r) ** 2)
    out, kw = _state(m, k, fused, active)
    grid_round_plain(p, g, q, qid, r2, k, out=out, **kw)
    want = _flat(out, kw)
    assert want[3].item() > 0  # the rows ran
    for s in SPLITS:
        out, kw = _state(m, k, fused, active)
        grid_round_split_plain(p, g, q, qid, r2, k, s, out=out, tile=TILE,
                               **kw)
        for name, x, y in zip(("d2", "idx", "found", "n_tests", "unres",
                               "res_round", "executed"), _flat(out, kw), want):
            assert torch.equal(x, y), (s, name)


@pytest.mark.parametrize("kind", ["ties", "collapsed"])
@pytest.mark.parametrize("k", [8, 32, 64, 100])
def test_split_round_matches_the_reference(kind, k):
    """The split rounds against the JAX reference's ``fixed_radius_round``
    (its ``_chunk_candidates``) on the same grid: d2, idx, found, n_tests,
    at a small tile for every S and at the kernel's own (512 slots at
    k <= 32, 1024 above) at S = 8."""
    from repro.core.fixed_radius import fixed_radius_round as jax_round

    pts, r = _cloud(kind)
    jg, g = _grids(pts, r)
    n = len(pts)
    rows = np.random.default_rng(k).choice(n, 128, replace=False)
    q = pts[rows]
    qid = rows.astype(np.int32)
    want = jax_round(pts, jg, q, qid, r, k, chunk=128)
    r2 = float(np.float32(r) ** 2)
    for s, tile in [(s, TILE) for s in SPLITS] + [(8, 512 if k <= 32
                                                    else 1024)]:
        out, kw = _state(len(rows), k, False, None)
        grid_round_split_plain(torch.from_numpy(pts), g, torch.from_numpy(q),
                               torch.from_numpy(qid), r2, k, s, out=out,
                               tile=tile, **kw)
        for x, y in zip(out, want[:3]):
            assert np.array_equal(x.numpy(), np.asarray(y)), (s, tile)
        assert kw["tests"].item() == want[3]


@pytest.mark.parametrize("splits", [1, 2, 3, 8, 40])
@pytest.mark.parametrize("tile", [1, 4, 7])
def test_split_of_cuts_the_walk_into_contiguous_shares(splits, tile):
    """``_split_of``: along each row's walk (stencil cells in order, each
    bucket's live slots from slot 0) the split index never falls, a tile
    lies in one split, and split s holds the tiles [G * s // S,
    G * (s + 1) // S) of the row's G, so shares differ by a tile at most."""
    gen = torch.Generator().manual_seed(splits * 10 + tile)
    chunk, n_cells, cap = 16, 27, 12
    fill = torch.randint(0, cap + 1, (chunk, n_cells), generator=gen)
    fill[0] = 0  # a row with no candidate at all
    live = torch.arange(cap) < fill[..., None]
    which = _split_of(live, splits, tile)
    for r in range(chunk):
        walk = which[r][live[r]]  # walk order: cell-major, slot-minor
        assert torch.all(walk[1:] >= walk[:-1])
        tiles = -(-fill[r] // tile)
        n_tiles = int(tiles.sum())
        got = torch.zeros(splits, dtype=torch.int64)
        for c in range(n_cells):
            for j in range(int(tiles[c])):
                part = which[r, c, j * tile:(j + 1) * tile][
                    live[r, c, j * tile:(j + 1) * tile]]
                assert torch.all(part == part[0])
                got[part[0]] += 1
        want = [n_tiles * (s + 1) // splits - n_tiles * s // splits
                for s in range(splits)]
        assert got.tolist() == want
