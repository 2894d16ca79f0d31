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
    cell_keys,
    fixed_radius_round,
    grid_round,
    grid_round_plain,
)
from repro_torch.core.grid import GridCapError, build_grid, hash_coords

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
    # memo contents and the _hits / _misses counters; the port's memo also
    # counts its probes' passes and host seconds, which the reference lacks
    assert jc == {key: v for key, v in tc.items()
                  if key not in ("_passes", "_seconds")}
    assert tc["_hits"] == 1 and tc["_misses"] == 3
    assert tc["_passes"] >= tc["_misses"] and tc["_seconds"] > 0.0


# -- the sizing probe on the points' device ----------------------------------


def numpy_probe(pts, radius, *, force_table_size=0, force_cap=0,
                probe_cache=None, max_bucket_elems=1 << 25, load_factor=0.5):
    """The reference's table-sizing probe (the host half of
    ``repro.core.grid.build_grid``, whose module imports JAX) in its own
    numpy, with the port's count of passes in the memo:
    (table_size, cap, res, cell, lo)."""
    n_valid, d = pts.shape
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    radius = float(max(radius, 1e-12))
    res = np.clip(np.floor(extent / radius).astype(np.int64), 1, 1 << 20)
    use_cache = (
        probe_cache is not None and not force_table_size and not force_cap
    )
    probe_key = (n_valid, tuple(int(x) for x in res)) if use_cache else None
    cached = probe_cache.get(probe_key) if use_cache else None
    if cached is not None:
        probe_cache["_hits"] = probe_cache.get("_hits", 0) + 1
        table_size, cap, res_t = cached
        res = np.asarray(res_t, np.int64)
        return table_size, cap, res, (extent / res).astype(np.float32), lo
    passes = 0
    while True:
        passes += 1
        cell = (extent / res).astype(np.float32)
        coords = np.clip(
            np.floor((pts - lo) / cell).astype(np.int64), 0, res - 1
        )
        packed = coords[:, 0]
        for a in range(1, d):
            packed = packed * res[a] + coords[:, a]
        n_occ = len(np.unique(packed))
        table_size = force_table_size or 1 << max(
            0, (max(int(n_occ / load_factor), 16) - 1).bit_length())
        occ = np.bincount(hash_coords(coords, table_size),
                          minlength=table_size)
        needed_cap = 1 << max(0, (max(int(occ.max()), 1) - 1).bit_length())
        if force_cap:
            assert needed_cap <= force_cap, (needed_cap, force_cap)
            cap = force_cap
            break
        cap = needed_cap
        if table_size * cap <= max_bucket_elems or int(res.max()) == 1:
            break
        res = np.maximum(res // 2, 1)
    if use_cache:
        probe_cache["_misses"] = probe_cache.get("_misses", 0) + 1
        probe_cache[probe_key] = (table_size, cap, tuple(int(r) for r in res))
    if probe_cache is not None:
        probe_cache["_passes"] = probe_cache.get("_passes", 0) + passes
    return table_size, cap, res, cell, lo


def _hold_probe(got, want):
    """A grid's (table_size, cap, res, cell, lo) bit for bit against
    ``numpy_probe``'s."""
    table_size, cap, res, cell, lo = want
    assert (got.table_size, got.cap) == (table_size, cap)
    assert got.res == tuple(int(r) for r in res)
    assert got.cell_size.tobytes() == cell.tobytes()
    assert got.origin.cpu().numpy().tobytes() == lo.tobytes()


def _probe_memos(pts, radii, device, **kw):
    """Build at each radius on ``device`` with one memo, holding each grid's
    probe against ``numpy_probe`` with another; returns both memos."""
    dpts = torch.from_numpy(pts).to(device)
    got_memo, want_memo = {}, {}
    grids = []
    for r in radii:
        g = build_grid(pts, r, device_points=dpts, probe_cache=got_memo,
                       **kw)
        _hold_probe(g, numpy_probe(pts, r, probe_cache=want_memo, **kw))
        grids.append(g)
    assert got_memo.pop("_seconds") > 0.0
    return got_memo, want_memo, grids


DEVICES = ["cpu", pytest.param("cuda", marks=needs_card)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cloud", CLOUDS)
def test_probe_on_the_points_device_is_the_numpy_probe(cloud, device):
    """The probe runs where the points live and sizes every grid as the
    reference's numpy does, memo and counters included."""
    pts = make_dataset(cloud, 1500, seed=3)
    ext = float((pts.max(0) - pts.min(0)).max())
    got, want, _ = _probe_memos(
        pts, (ext / 300, ext / 40, ext / 5, ext / 40), device)
    assert got == want and got["_hits"] == 1 and got["_misses"] == 3


@pytest.mark.parametrize("device", DEVICES)
def test_probe_coarsens_lidar_2e20_to_the_collapsed_grid(device):
    """A 2^20-point LiDAR map at the benchmark map's start radius: ten
    coarsenings down to the (2, 3, 2) grid, as the reference's probe."""
    pts = make_dataset("kitti", 1 << 20, seed=0)
    got, want, (g,) = _probe_memos(pts, (0.165,), device)
    assert got == want and got["_passes"] == 10
    assert (g.table_size, g.cap, g.res) == (32, 524288, (2, 3, 2))


@pytest.mark.parametrize("device", DEVICES)
def test_probe_divides_points_on_cell_edges_exactly(device):
    """Points on the edges of 41/64-wide cells: a true float32 division puts
    each in its own cell (513 cells, table 2048), where a multiply by the
    rounded reciprocal drops 210 of them a cell (505 cells, table 1024)."""
    pts = np.zeros((514, 3), np.float32)
    pts[:, 0] = np.arange(514, dtype=np.float32) * np.float32(41 / 64)
    got, want, (g,) = _probe_memos(pts, (41 / 64,), device)
    assert got == want
    assert (g.table_size, g.cap, g.res) == (2048, 2, (513, 1, 1))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf", "all"])
def test_probe_non_finite_axis_has_one_cell(bad, device):
    """A non-finite coordinate makes its axis' extent inf or NaN, so the
    reference gives that axis one cell and casts anything there to cell 0;
    the probe follows it on either device."""
    pts = make_dataset("kitti", 600, seed=4).copy()
    if bad == "all":
        pts[[5, 50, 500], 1] = [np.nan, np.inf, -np.inf]
    else:
        pts[[7, 70], 1] = float(bad)
    got, want, grids = _probe_memos(pts, (0.5, 3.0, 0.5), device)
    assert got == want and got["_misses"] == 2 and got["_hits"] == 1
    assert all(g.res[1] == 1 for g in grids)
    if device != "cpu":
        return
    # the reference's own build: what the probe decides (the binning's
    # arrays are not the probe's)
    for g, r in zip(grids, (0.5, 3.0)):
        w, t = _grid_arrays(jax_build_grid(pts, r)), _grid_arrays(g)
        for key in ("origin", "inv_cell", "res", "table_size", "cap",
                    "cell_size"):
            assert np.array_equal(np.asarray(t[key]), np.asarray(w[key]),
                                  equal_nan=True), key


@pytest.mark.parametrize("forced", ["below", "exact"])
def test_probe_under_a_forced_shape(forced):
    """Under a forced (table_size, cap) the memo is bypassed; a cap below
    what the points need raises where the reference's assertion fails, and
    an adequate one builds the reference's grid."""
    pts = make_dataset("kitti", 600, seed=4)
    with pytest.raises(AssertionError) as ref:
        jax_build_grid(pts, 0.5, force_table_size=64, force_cap=1)
    needed_cap = ref.value.args[0][0]
    assert needed_cap > 1
    memo = {}
    if forced == "below":
        with pytest.raises(GridCapError, match=f"cap {needed_cap} > forced"):
            build_grid(pts, 0.5, force_table_size=64,
                       force_cap=needed_cap // 2, probe_cache=memo)
        assert memo == {}
        return
    g = build_grid(pts, 0.5, force_table_size=64, force_cap=needed_cap,
                   probe_cache=memo)
    want = jax_build_grid(pts, 0.5, force_table_size=64, force_cap=needed_cap)
    got = _grid_arrays(g)
    for key, w in _grid_arrays(want).items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(w)), key
    assert memo["_passes"] == 1 and set(memo) == {"_passes", "_seconds"}
    assert (g.table_size, g.cap) == (64, needed_cap)


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


# -- the cell order the wrapper hands the kernel ----------------------------


def _odd_queries(pts, rng):
    """Cloud rows, rows outside the grid's box (clamped to its edge cells),
    and rows with a non-finite coordinate (that axis counts as 0)."""
    d = pts.shape[1]
    q = pts[rng.choice(len(pts), 200, replace=False)].copy()
    lo, hi = pts.min(0), pts.max(0)
    out = np.stack([lo - 5.0, hi + 5.0, (lo + hi) / 2 + (hi - lo) * 3.0,
                    lo - 1e-3]).astype(np.float32)
    bad = np.tile(pts[:1], (6, 1))
    bad[0, 0] = np.nan
    bad[1, d - 1] = np.inf
    bad[2, 0] = -np.inf
    bad[3, :] = np.nan
    bad[4, d - 1] = -np.inf
    bad[5, 0] = np.inf
    return np.concatenate([q, out, bad]).astype(np.float32)


@pytest.mark.parametrize("cloud,radius_frac", [
    ("kitti", 1 / 50), ("porto", 1 / 80), ("uniform", 1 / 7), ("iono", 1 / 3),
])
@pytest.mark.parametrize("fused", [False, True])
def test_cell_keys_are_the_reference_cells(cloud, radius_frac, fused):
    """The key the wrapper sorts by decodes to the cell the reference's
    ``cell_coords_of`` gives each query (non-finite coordinates as 0,
    out-of-box queries clamped); in fused mode resolved rows sort last."""
    import jax.numpy as jnp
    from repro.core.grid import cell_coords_of as jax_cells

    rng = np.random.default_rng(len(cloud))
    pts = make_dataset(cloud, 1500, seed=4)
    ext = float((pts.max(0) - pts.min(0)).max())
    g = build_grid(pts, ext * radius_frac)
    q = _odd_queries(pts, rng)
    unres = (torch.from_numpy((np.arange(len(q)) % 4 != 0).astype(np.uint8))
             if fused else None)
    key = cell_keys(torch.from_numpy(q), g, unres).numpy()
    cells = math.prod(g.res)
    if fused:
        resolved = unres.numpy() == 0
        assert (key[resolved] >= cells).all() and (key[~resolved] < cells).all()
        key = np.where(resolved, key - cells, key)
    coords = np.zeros((len(q), len(g.res)), np.int64)
    rem = key.copy()
    for a in range(len(g.res) - 1, -1, -1):
        coords[:, a] = rem % g.res[a]
        rem //= g.res[a]
    assert (rem == 0).all()
    want = np.asarray(jax_cells(
        jnp.where(jnp.isfinite(q), q, 0.0), np.asarray(g.origin),
        np.asarray(g.inv_cell), np.asarray(g.res, np.int32)))
    assert np.array_equal(coords, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("radius", [0.03, 0.3])
def test_grid_round_plain_is_order_free(fused, radius):
    """A round on a row permutation of the queries gives every row the same
    outputs (and the same test count): the cell order the kernel is handed
    never changes an answer."""
    rng = np.random.default_rng(int(radius * 100) + fused)
    pts = make_dataset("kitti", 1200, seed=6)
    p = torch.from_numpy(pts)
    g = build_grid(pts, radius)
    q = torch.from_numpy(_odd_queries(pts, rng))
    m = q.shape[0]
    qid = torch.from_numpy(
        np.where(np.arange(m) < 100, rng.choice(1200, m), 1200)
        .astype(np.int32))
    perm = torch.from_numpy(rng.permutation(m))
    k = 7
    unres0 = torch.from_numpy((np.arange(m) % 3 != 0).astype(np.uint8))
    runs = []
    for order in (torch.arange(m), perm):
        out = (torch.full((m, k), -1.0),
               torch.full((m, k), -1, dtype=torch.int32),
               torch.full((m,), -1, dtype=torch.int32))
        tests = torch.zeros(1, dtype=torch.int64)
        kw = {}
        if fused:
            kw = dict(unres=unres0[order].clone(),
                      res_round=torch.full((m,), -1, dtype=torch.int32), t=2,
                      executed=torch.zeros(1, dtype=torch.int32))
        grid_round_plain(p, g, q[order].contiguous(), qid[order].contiguous(),
                         float(np.float32(radius) ** 2), k, out=out,
                         tests=tests, **kw)
        inv = torch.argsort(order)
        state = [t[inv] for t in out]
        if fused:
            state += [kw["unres"][inv], kw["res_round"][inv]]
        runs.append((state, tests.item()))
    (a, ta), (b, tb) = runs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ta == tb > 0


# -- on the card: both designs, fused mode, and an unsorted permutation -----


def _card_round(fn, p, g, q, qid, r2, k, fused_unres=None, **kw):
    dev = q.device
    m = q.shape[0]
    out = (torch.full((m, k), -1.0, device=dev),
           torch.full((m, k), -1, dtype=torch.int32, device=dev),
           torch.full((m,), -1, dtype=torch.int32, device=dev))
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    extra = {}
    if fused_unres is not None:
        extra = dict(unres=fused_unres.clone(),
                     res_round=torch.full((m,), -1, dtype=torch.int32,
                                          device=dev), t=4,
                     executed=torch.zeros(1, dtype=torch.int32, device=dev))
    fn(p, g, q, qid, r2, k, out=out, tests=tests, **extra, **kw)
    return list(out) + [tests] + [extra[x] for x in ("unres", "res_round",
                                                      "executed") if extra]


@needs_card
@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("k", [8, 32, 33, 64, 100, 128, 1024, 1100])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_grid_round_designs_match_plain(coarse, k, fused):
    """The fine (a thread or a warp a query) and the coarse (shared-memory
    tiles) designs against the plain version, non-fused and fused, on
    queries that are not in cell order, at every list: one thread's to
    k = 32, the warp's register lists of 2 to 32 entries a lane (k = 33 to
    1024) and the row list above."""
    from repro_torch.core.fixed_radius import coarse_design

    dev = torch.device("cuda")
    rng = np.random.default_rng(k + 2 * coarse + fused)
    pts = make_dataset("kitti", 1 << 15, seed=1)
    p = torch.from_numpy(pts).to(dev)
    r = 40.0 if coarse else 0.05
    g = build_grid(pts, r, device_points=p)
    assert coarse_design(g) == coarse
    m = 3000
    rows = rng.permutation(len(pts))[:m]
    qn = pts[rows] + np.float32(1e-4)
    qn[:3] = _odd_queries(pts, rng)[-3:]  # non-finite rows
    q = torch.from_numpy(qn).to(dev)
    qid = torch.from_numpy(rows.astype(np.int32)).to(dev)
    unres = (torch.from_numpy((rng.random(m) < 0.6).astype(np.uint8)).to(dev)
             if fused else None)
    r2 = float(np.float32(r) ** 2)
    a = _card_round(grid_round, p, g, q, qid, r2, k, unres)
    b = _card_round(grid_round_plain, p, g, q, qid, r2, k, unres)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@needs_card
@pytest.mark.parametrize("coarse", [False, True])
def test_cuda_grid_round_ignores_the_order_it_is_handed(coarse):
    """The coarse design recomputes every query's cell: a random
    permutation in place of the sorted one changes no output.  The fine
    design works on the rows in their own order and refuses one."""
    from repro_torch.core.fixed_radius import coarse_design
    from repro_torch.kernels.build import extension

    dev = torch.device("cuda")
    pts = make_dataset("kitti", 1 << 14, seed=2)
    p = torch.from_numpy(pts).to(dev)
    r = 40.0 if coarse else 0.05
    g = build_grid(pts, r, device_points=p)
    m, k = 2000, 8
    q = p[:m].contiguous()
    qid = torch.arange(m, dtype=torch.int32, device=dev)
    r2 = float(np.float32(r) ** 2)
    want = _card_round(grid_round_plain, p, g, q, qid, r2, k)
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(0)).to(dev)
    out = [torch.empty_like(t) for t in want[:3]]
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    assert coarse_design(g) == coarse
    launch = lambda: extension().grid_round(  # noqa: E731
        p, g.buckets, g.point_cells, g.origin, g.inv_cell, g.res_arr, q, qid,
        perm, None, k, r2, coarse, *out, None, None, 0, tests, None, None,
        None, None, None, 1)
    if not coarse:
        with pytest.raises(RuntimeError, match="launch failed"):
            launch()
        return
    launch()
    torch.cuda.synchronize()
    for x, y in zip(out + [tests], want):
        assert torch.equal(x, y)


@needs_card
@pytest.mark.parametrize("k", [8, 32, 64, 100, 1100])
@pytest.mark.parametrize("n_active", [1, 5, 206])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_grid_round_split_matches_plain(k, n_active, fused):
    """The coarse design split across blocks: S forced to 1, 2, 3 and 8,
    and the S the kernel derives from the count of rows that run (> 1 for
    these few rows, as the launch reports it), against the plain version.
    The rows that run are the ones whose cells sort last, at the end of the
    input order; fused, the other 3000 - n_active rows are resolved and
    must stay untouched."""
    from repro_torch.core.fixed_radius import _launch, coarse_design

    dev = torch.device("cuda")
    pts = make_dataset("kitti", 1 << 15, seed=1)
    p = torch.from_numpy(pts).to(dev)
    g = build_grid(pts, 40.0, device_points=p)
    assert coarse_design(g)
    rng = np.random.default_rng(k + n_active)
    m = 3000 if fused else n_active
    rows = torch.from_numpy(rng.permutation(len(pts))[:3000]).to(dev)
    rows = rows[torch.argsort(cell_keys(p[rows], g), stable=True)][-m:]
    q = (p[rows] + 1e-4).contiguous()
    qid = rows.to(torch.int32)
    unres = None
    if fused:
        unres = torch.zeros(m, dtype=torch.uint8, device=dev)
        unres[m - n_active:] = 1
    r2 = float(np.float32(40.0) ** 2)
    want = _card_round(grid_round_plain, p, g, q, qid, r2, k, unres)
    # positions a coarse block serves: 128 threads of 2 or 1 queries, or 8
    # warps of 4 (lists of <= 8 entries a lane) or 1 (the row list)
    per_block = {8: 256, 32: 128, 64: 32, 100: 32, 1100: 8}[k]
    for splits in (0, 1, 2, 3, 8):
        plan = torch.full((2,), -1, dtype=torch.int32, device=dev)
        got = _card_round(
            lambda *a, **kw: _launch(*a[:6], True, splits=splits, plan=plan,
                                     **kw),
            p, g, q, qid, r2, k, unres)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), splits
        tiles, s = plan.tolist()
        assert s == splits if splits else s > 1, (splits, s)
        assert tiles == -(-n_active // per_block), tiles


@needs_card
@pytest.mark.parametrize("cloud,d,frac,coarse", [
    ("porto", 2, 1 / 200, False), ("porto", 2, 1 / 20, True),
    ("kitti", 1, 1 / 100, False), ("kitti", 1, 1 / 2000, False),
    ("kitti", 1, 1 / 10, True),
])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_grid_round_low_d_matches_plain(cloud, d, frac, coarse, fused):
    """The d = 1 and d = 2 instantiations of both designs (the heavy-tailed
    2-D cloud and a 1-D cut of the 3-D one, each on a fine and a coarse
    grid)."""
    from repro_torch.core.fixed_radius import coarse_design

    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    pts = np.ascontiguousarray(make_dataset(cloud, 1 << 14, seed=3)[:, :d])
    p = torch.from_numpy(pts).to(dev)
    r = float((pts.max(0) - pts.min(0)).max()) * frac
    g = build_grid(pts, r, device_points=p)
    assert coarse_design(g) == coarse
    m = 2000
    rows = rng.permutation(len(pts))[:m]
    q = p[torch.from_numpy(rows).to(dev)].contiguous()
    qid = torch.from_numpy(rows.astype(np.int32)).to(dev)
    unres = (torch.from_numpy((rng.random(m) < 0.7).astype(np.uint8)).to(dev)
             if fused else None)
    r2 = float(np.float32(r) ** 2)
    a = _card_round(grid_round, p, g, q, qid, r2, 8, unres)
    b = _card_round(grid_round_plain, p, g, q, qid, r2, 8, unres)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@needs_card
@pytest.mark.parametrize("radius_frac", [0.02, 0.3])
def test_cuda_fixed_radius_index_matches_cpu(radius_frac):
    """The ``fixed_radius`` backend on the card launches the grid-round
    kernel for every round and answers kNN, hybrid and range exactly as
    the same index on the CPU (on a fine grid and on a collapsed one)."""
    from repro_torch import HybridSpec, KnnSpec, RangeSpec, build_index
    from repro_torch.kernels import build

    pts = make_dataset("kitti", 3000, seed=4)
    qs = make_dataset("kitti", 100, seed=5)
    r = float((pts.max(0) - pts.min(0)).max()) * radius_frac
    cpu = build_index(pts, backend="fixed_radius", device="cpu", radius=r)
    build.reset_launches()
    gpu = build_index(pts, backend="fixed_radius", device="cuda", radius=r)
    for q in (qs, None):
        for spec in (KnnSpec(8), HybridSpec(40, r), RangeSpec(r)):
            got, want = gpu.query(q, spec), cpu.query(q, spec)
            keys = (("offsets", "idxs", "dists") if hasattr(want, "offsets")
                    else ("dists", "idxs", "found"))
            for key in keys:
                assert np.array_equal(getattr(got, key), getattr(want, key))
            assert got.n_tests == want.n_tests
    assert build.launch_counts()["grid_round"] > 0
