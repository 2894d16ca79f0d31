"""The port's hash grid and fixed-radius round against the JAX package.

``build_grid`` must give the reference's arrays and probe-cache counters
exactly, and one ``fixed_radius_round`` fed the *same* grid (the JAX
grid's arrays through ``repro_torch.convert.grid_from_numpy``) must give
bitwise equal d2, idx, found and n_tests.  Sizes keep n_tests far below
2^24, where the reference's float32 test counter is still exact.  The
CUDA grid-round kernel is held against the plain version on the card only;
the JAX package is imported inside the parity tests, so the card tests
also run where JAX is not installed.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.convert import grid_from_numpy
from repro_torch.core.datasets import make_dataset
from repro_torch.core.fixed_radius import (
    fixed_radius_round,
    grid_round,
    grid_round_plain,
)
from repro_torch.core.grid import build_grid, hash_coords

torch.set_num_threads(1)

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)

CLOUDS = ["uniform", "porto", "road", "iono", "kitti"]


def jax_build_grid(*args, **kw):
    from repro.core.grid import build_grid as ref

    return ref(*args, **kw)


def jax_round(*args, **kw):
    from repro.core.fixed_radius import fixed_radius_round as ref

    return ref(*args, **kw)


def jax_hash(*args, **kw):
    from repro.core.grid import hash_coords as ref

    return ref(*args, **kw)


def _grid_arrays(g):
    return dict(
        buckets=np.asarray(g.buckets),
        point_cells=np.asarray(g.point_cells),
        origin=np.asarray(g.origin),
        inv_cell=np.asarray(g.inv_cell),
        res=tuple(g.res),
        table_size=g.table_size,
        cap=g.cap,
        n_points=g.n_points,
        cell_size=np.asarray(g.cell_size),
    )


def _to_port(g):
    return grid_from_numpy(device="cpu", **_grid_arrays(g))


def test_hash_coords_matches_uint32_wraparound():
    rng = np.random.default_rng(0)
    c = rng.integers(-3, 1 << 20, size=(500, 3)).astype(np.int32)
    for d in (1, 2, 3):
        want = jax_hash(c[:, :d].astype(np.int64), 1 << 14)
        got = hash_coords(torch.from_numpy(c[:, :d]), 1 << 14)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cloud", CLOUDS)
def test_build_grid_arrays_and_probe_counters(cloud):
    pts = make_dataset(cloud, 1500, seed=3)
    ext = float((pts.max(0) - pts.min(0)).max())
    jc, tc = {}, {}
    for r in (ext / 300, ext / 40, ext / 5, ext / 40):
        want = _grid_arrays(jax_build_grid(pts, r, probe_cache=jc))
        got = _grid_arrays(build_grid(pts, r, probe_cache=tc))
        for key, w in want.items():
            g = got[key]
            if isinstance(g, torch.Tensor):
                g = g.numpy()
            assert np.array_equal(np.asarray(g), np.asarray(w)), key
    assert jc == tc  # memo contents and the _hits / _misses counters
    assert tc["_hits"] == 1 and tc["_misses"] == 3


def _queries(pts, rng, m):
    q = pts[rng.choice(len(pts), m, replace=False)] + rng.normal(
        scale=1e-3, size=(m, pts.shape[1])
    ).astype(np.float32)
    far = np.full((2, pts.shape[1]), 40.0, np.float32)
    far[1] = -35.0
    return np.concatenate([q, far]).astype(np.float32)


@pytest.mark.parametrize("cloud", CLOUDS)
@pytest.mark.parametrize("k", [1, 8, 40])
def test_fixed_radius_round_bitwise(cloud, k):
    rng = np.random.default_rng(len(cloud) + k)
    pts = make_dataset(cloud, 1500, seed=5)
    ext = float((pts.max(0) - pts.min(0)).max())
    n = len(pts)
    for r in (ext / 60, ext / 12):
        jg = jax_build_grid(pts, r)
        tg = _to_port(jg)
        # self rows (ids), then external rows (id n, incl. far-out ones)
        q = np.concatenate([pts[:300], _queries(pts, rng, 100)])
        qid = np.concatenate(
            [np.arange(300), np.full(102, n)]
        ).astype(np.int32)
        want = jax_round(pts, jg, q, qid, r, k, chunk=128)
        got = fixed_radius_round(torch.from_numpy(pts), tg, q, qid, r, k)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[3] == want[3]


def test_fixed_radius_round_pad_rows_count_nothing():
    pts = make_dataset("kitti", 800, seed=1)
    jg = jax_build_grid(pts, 2.0)
    q = np.concatenate([pts[:5], np.full((3, 3), np.inf, np.float32)])
    qid = np.full((8,), 800, np.int32)
    want = jax_round(pts, jg, q, qid, 2.0, 4)
    got = fixed_radius_round(torch.from_numpy(pts), _to_port(jg), q, qid,
                             2.0, 4)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3] == want[3] and (got[2].numpy()[5:] == 0).all()


def test_grid_round_fused_mode_replaces_only_unresolved_rows():
    """The fused loop's contract: rows outside ``unres`` are left as they
    were; rows that run are replaced, and those that find >= k get the
    round index and leave the mask."""
    pts = make_dataset("porto", 1000, seed=2)
    p = torch.from_numpy(pts)
    g = build_grid(pts, 0.02)
    k = 6
    qid = torch.arange(1000, dtype=torch.int32)
    full = tuple(torch.empty(s, dtype=dt) for s, dt in (
        ((1000, k), torch.float32), ((1000, k), torch.int32),
        ((1000,), torch.int32)))
    t_full = torch.zeros(1, dtype=torch.int64)
    grid_round_plain(p, g, p, qid, 0.02 ** 2, k, out=full, tests=t_full)

    unres = torch.from_numpy((np.arange(1000) % 2).astype(np.uint8))
    run = unres.bool().clone()
    out = (torch.full((1000, k), -1.0), torch.full((1000, k), -1,
           dtype=torch.int32), torch.full((1000,), -1, dtype=torch.int32))
    res_round = torch.full((1000,), -1, dtype=torch.int32)
    tests = torch.zeros(1, dtype=torch.int64)
    executed = torch.zeros(1, dtype=torch.int32)
    grid_round(p, g, p, qid, 0.02 ** 2, k, out=out, tests=tests, unres=unres,
               res_round=res_round, t=3, executed=executed)
    for o, f in zip(out, full):
        assert torch.equal(o[run], f[run])
        assert (o[~run] == -1).all()
    resolved = run & (full[2] >= k)
    assert torch.equal(res_round == 3, resolved)
    assert torch.equal(unres.bool(), run & ~resolved)
    assert executed.item() == 1 and 0 < tests.item() < t_full.item()


# -- on the card: the CUDA kernel against its plain version ----------------


@needs_card
@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_cuda_grid_round_matches_plain(k):
    dev = torch.device("cuda")
    pts = make_dataset("kitti", 1 << 14, seed=0)
    p = torch.from_numpy(pts).to(dev)
    qid = torch.arange(len(pts), dtype=torch.int32, device=dev)
    for r in (0.05, 0.5):
        g = build_grid(pts, r, device_points=p)
        outs = []
        for fn in (grid_round, grid_round_plain):
            out = (torch.empty((len(pts), k), device=dev),
                   torch.empty((len(pts), k), dtype=torch.int32, device=dev),
                   torch.empty((len(pts),), dtype=torch.int32, device=dev))
            tests = torch.zeros(1, dtype=torch.int64, device=dev)
            fn(p, g, p, qid, float(np.float32(r) ** 2), k, out=out,
               tests=tests)
            outs.append((out, tests))
        torch.cuda.synchronize()
        (a, ta), (b, tb) = outs
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert ta.item() == tb.item()
        assert math.isfinite(a[0][:, 0].min().item())
