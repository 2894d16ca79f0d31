#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds both CUDA kernels from ``src/repro_torch/csrc`` (one
``torch.utils.cpp_extension.load`` call), holds each against its plain
PyTorch version on the card, then drives the port's entry points (the
trueknn, brute, fixed_radius, distributed, sharded and mutable backends,
the planner's generic routes, all-pairs self-queries, the graph
workloads, the server, the kNN-LM datastore and the launcher) at full
width through the user API and checks what comes out:

1. device and build;
2. ``pairwise_topk`` kernel vs plain version: L2 at d = 2, 3, 16, L1, L∞,
   cosine, self ids, finite radii, k in {1, 5, 8, 32, 64, 300}, on
   main-path shapes (N = 2^20), the split-N path (S > 1 ranges and the
   merge) checked taken where it must be: the sampler's Q = 100, k = 300,
   and exact duplicate points on both sides of every range boundary of the
   kernel's own split; the ``l2diff`` form at d = 12; then a ``row_mask``
   that is all zero and one that keeps every third row (the other rows
   must stay untouched).  Counts exact; values bitwise where both take the
   diff form (d <= 8, and ``l2diff`` at any d), rtol 1e-6 for the d > 8
   identity form; index sets compared by distance where values are not
   bitwise;
3. grid-round kernel vs plain version on the first three scheduled grids
   of the full cloud (the fine, one-thread-a-query design), 16384 seeded
   queries, and on the collapsed grid whose stencil walks the most slots
   and the coarsest (largest cap), 2048 of them, eight blocks of the
   coarse, shared-memory design: d2, idx, found, n_tests bitwise; then
   fused mode on the heaviest grid with a partly cleared ``unres`` mask,
   once with the rows as drawn and once out of cell order: also
   ``unres``, ``res_round`` and ``executed`` bitwise;
4. main path: ``build_index(kitti 2^20, backend="trueknn")`` and two
   self-query ``KnnSpec(8)`` batches (sampled, then warm), with 4096 rows
   checked against the brute backend;
5. brute ``RangeSpec`` at full width on 4096 rows, CSR vs the plain
   version's;
6. the heavy-tailed 2-D cloud (porto 2^18): fused self-query with its
   rounds' grids, and a 4096-row query whose fused and host-loop answers
   and round stats must be equal;
7. kernel times against their bounds at every timed shape: ``pairwise_topk``
   at Q = 4096, k = 32 and at the sampler's Q = 100, k = 5 (each also as
   first pass and merge apart); ``grid_round`` on round 0 of batch 1 and
   one non-fused launch on the heaviest scheduled grid at full width,
   whose n_tests must be exactly N * N when the grid has res <= 2 per axis;
8. ``grid_round``'s two designs timed on every scheduled grid of kitti,
   porto, road and uniform (the fused loop's rounds, and every row on
   the grids between fine and collapsed), held bitwise equal to each
   other, against the design the wrapper picks;
9. ``build_index(kitti 2^20, backend="fixed_radius", radius=r)`` with r
   phase 4's median 8th-NN distance: two ``HybridSpec(8, r)`` self-query
   batches (the second on the cached grid), ``KnnSpec(8)`` at the cfg
   radius equal to them bitwise, 4096 rows against the brute backend as in
   phase 4, and ``RangeSpec(r)`` on phase 5's rows, its CSR bitwise equal
   to phase 5's;
10. the planner's generic routes on 4096 rows, each against the brute
   backend's native answer: cosine ``KnnSpec(8)`` through the ``l2_view``
   companion of phase 4's trueknn index (to the reference tests' TOL),
   L1 ``KnnSpec(8)`` and L∞ ``RangeSpec`` through ``brute_metric``
   (bitwise), cosine ``HybridSpec`` through phase 9's index's view (TOL);
11. ``AllPairsSpec(8)`` on trueknn, equal to phase 4's batch 2 bitwise,
   chunked (4 blocks) equal to the whole batch, ``AllPairsSpec`` range at
   r on trueknn and on fixed_radius (offsets and distances bitwise equal,
   indices equal up to the order of neighbors at equal distance, which
   follows each backend's grid), the
   counted range's two rounds timed at full width, ``build_knn_graph`` and
   ``dbscan`` (the union-find's host seconds apart from the device part);
12. ``build_index(kitti 2^22, backend="distributed")`` on a ``DeviceMesh``
   whose model axis holds the one card at 4 positions (2^20 points a
   shard, ``configs/trueknn.py``'s widths), two ``KnnSpec(8)`` batches of
   2^16 rows, equal bitwise to the brute backend and to a one-position
   mesh; round 0's kernel call at the last position (S = 1, shifted self
   ids) held bitwise against the plain version;
13. ``distributed_trueknn_grid`` on phase 12's mesh over uniform 2^22 (on
   kitti the reference's shared stacked-grid shape needs up to 2^40 slots
   a shard) and 2^16 rows: distances to TOL and indices up to the order
   of tied neighbors against the dense engine on the same rows, fewer
   candidate tests than it, host grid builds apart; the last shard's
   ``grid_round`` call of the first and the last round held bitwise
   against the plain grid round on the same ``Grid`` view and rows;
14. ``build_index(kitti 2^20, backend="sharded", n_shards=8)`` with
   trueknn children on the host: ``KnnSpec(8)`` on two batches of 2^16
   rows (the second on the warm seed), ``HybridSpec(8, r)`` and
   ``RangeSpec(r)`` on phase 5's rows, ``AllPairsSpec(8)``, each held
   against the monolithic answer (phases 4, 5) bitwise: distances and
   indices, the hybrid's found as min(8, trueknn's ball count), the range
   CSR's offsets; pruned visits and child dispatches printed;
15. the same 8 shards with ``placement="devices"`` on the default mesh
   (the card): ``KnnSpec(8)`` on phase 14's two batches (the fused rounds:
   Alg. 2 seed, then the warm seed), cosine ``KnnSpec(8)`` (the per-round
   path), ``HybridSpec(8, r)``, ``RangeSpec(r)`` and an L1 ``RangeSpec``
   whose balls need the escalated second dispatch, on phase 5's rows; each
   bitwise equal to phase 14's answer, the monolithic trueknn's, phase 5's
   CSR or brute L1; fabric dispatches, host syncs and launches printed per
   batch; a 6-shard index on ``DeviceMesh([card] * 4)`` rebalanced (answers
   unchanged bitwise, every position occupied); round 0's call of one slot,
   the escalation's call of one slot and an ``l2diff`` call at d = 12 held
   bitwise against the plain version and timed;
16. ``backend="mutable"`` over a trueknn base of kitti 2^20: 2^14 rows of a
   second kitti draw inserted (8 sealed brute deltas), 64 ids deleted;
   ``KnnSpec(8)``, ``HybridSpec(8, r)``, ``RangeSpec(r)`` on phase 5's rows
   against a trueknn index rebuilt over the live rows (``map_to_stable``;
   distances bitwise, indices up to the order of tied neighbors, which
   follows each grid); after ``compact()`` bitwise, ties included; one
   background compaction, joined, its answers during and after equal;
17. ``NeighborServer`` in worker-thread mode over three tenants of the
   earlier phases (phase 4's warm trueknn index as ``"lidar"``, phase 15's
   placed index, phase 16's compacted mutable index): a Poisson open loop
   of 4096 single-row ``KnnSpec(8)`` requests on ``"lidar"`` at 20,000
   requests/s; multi-row ``KnnSpec(8)``, ``HybridSpec(8, r)`` and
   ``RangeSpec(r)`` requests on every tenant; an insert and a delete on
   ``"mutable"``, each followed by a read that must see it; a
   ``submit_graph(8)`` ticket on ``"lidar"``.  Every ticket bitwise equal
   to a direct ``index.query`` of its rows (found too), the graph to
   phase 11's; the server's counters reconcile and its batches coalesce;
   per bucket: requests/s, p50/p99, batch histogram, launches and host
   reads;
18. ``max_knn_distance`` and ``percentile_knn_distance`` on kitti 2^20,
   k = 8, equal to phase 4's batch 2 (max; 99th percentile of the 8th
   column); a kNN-LM datastore of 2^20 synthetic hidden states of width
   1024, ``knn_logprobs`` on 4096 rows, vocab 32,768: its retrieval
   bitwise equal to a direct query, rows summing to 1 within 1e-5, within
   1e-6 of the reference's host formula; then
   ``repro_torch.launch.serve.main`` in process: ``--mode knn`` on kitti
   2^20 (open loop), the placed sharded index on a 4-position mesh,
   ``--mode graph`` and ``--mode dbscan`` on 2^16 points;
   then the kernels line and the device line.

Every check raises, so any failure exits non-zero.  The launch counters
are zeroed just before each entry point (phases 4, 5 and 9-18) and read
just after; a kernel of that path that was not launched fails the run.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores
N_MAIN = 1 << 20  # configs/trueknn.py: n_points = 1 << 20, dim = 3
N_PORTO = 1 << 18
N_SUB = 1 << 18  # subset of the main cloud for the other metrics
N_WIDE = 1 << 16  # d = 16 cloud for the matmul-identity form
ROWS = 4096
GRID_ROWS = 16384
DEGEN_ROWS = 2048  # 8 blocks of the coarse design at k = 8
SEED = 0
FINE_TEST_BUDGET = 1 << 36  # most tests phase 8 gives the fine design
CHUNK_ROWS = 1 << 18  # phase 11's chunked all-pairs: 4 blocks of the cloud
P_MESH = 4  # phases 12-13: model positions, 2^20 points each
MESH_ROUNDS = 24  # configs/trueknn.py: max_rounds
DIST_ROWS = 1 << 16  # configs/trueknn.py: n_queries = 1 << 16


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps, sync, warmup=True):
    """Median wall time of ``fn`` in ms, timed with CUDA events on the
    card (after one warm-up call unless ``warmup`` is False)."""
    import torch

    if warmup:
        fn()
    sync()
    times = []
    for _ in range(reps):
        if torch.cuda.is_available():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def shape_row(shape, ms, plain_ms, b, **extra):
    """One timed shape of a kernel for the kernels line."""
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], **extra}


def bound(bytes_moved, flops):
    """Least time on the card for the work (ms) and what bounds it."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# -- phase 2: pairwise_topk ------------------------------------------------


def _rows_by_distance(q, p, idx, n, metric):
    """Per row, the sorted float64 distances of the returned indices."""
    q64 = q.double()
    out = []
    for r in range(q.shape[0]):
        ii = idx[r][idx[r] < n].long()
        diff = p[ii].double() - q64[r]
        if metric == "l1":
            d = diff.abs().sum(-1)
        elif metric == "linf":
            d = diff.abs().amax(-1)
        else:
            d = (diff * diff).sum(-1)
        out.append(d.sort().values.cpu().numpy())
    return out


def compare_topk(tag, got, want, q, p, metric, bitwise):
    """Kernel vs plain outputs of one pairwise_topk case; returns the max
    absolute difference of the finite distances."""
    import torch

    (gd, gi, gc), (wd, wi, wc) = got, want
    check(torch.equal(gc, wc), f"{tag}: counts differ")
    fin = torch.isfinite(wd)
    check(torch.equal(torch.isfinite(gd), fin), f"{tag}: inf slots differ")
    err = float((gd[fin] - wd[fin]).abs().max().item()) if fin.any() else 0.0
    if bitwise:
        check(torch.equal(gd, wd), f"{tag}: values not bitwise (err {err})")
        check(torch.equal(gi, wi), f"{tag}: indices differ")
    else:
        torch.testing.assert_close(gd, wd, rtol=1e-6, atol=1e-6)
        sample = slice(0, min(64, q.shape[0]))
        for a, b in zip(
            _rows_by_distance(q[sample], p, gi[sample], p.shape[0], metric),
            _rows_by_distance(q[sample], p, wi[sample], p.shape[0], metric),
        ):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    return err


def phase_pairwise(dev, kitti, porto, rng):
    import torch

    from repro_torch.kernels.ops import l2_normalize, topk_engine
    from repro_torch.kernels.pairwise_topk import split_plan
    from repro_torch.kernels.ref import pairwise_topk_ref

    n = kitti.shape[0]
    sub = kitti[torch.as_tensor(rng.choice(n, N_SUB, replace=False),
                                device=dev)]
    wide = torch.as_tensor(
        rng.normal(size=(N_WIDE, 16)).astype(np.float32), device=dev
    )
    samp = torch.as_tensor(rng.choice(n, 100, replace=False), device=dev)
    rows = torch.as_tensor(rng.choice(n, ROWS, replace=False), device=dev)
    prow = torch.as_tensor(rng.choice(porto.shape[0], 1024, replace=False),
                           device=dev)
    srow = torch.arange(512, device=dev)
    wrow = torch.arange(512, device=dev)
    none = lambda m, pts: torch.full((m,), pts.shape[0], dtype=torch.int32,  # noqa: E731
                                     device=dev)
    ids = lambda r: r.to(torch.int32)  # noqa: E731
    cases = [
        # tag, queries, ids, points, metric, k, thr (kernel units)
        ("sampler l2 d3 k5", kitti[samp], none(100, kitti), kitti, "l2", 5,
         math.inf),
        ("brute l2 d3 k8 self", kitti[rows], ids(rows), kitti, "l2", 8,
         math.inf),
        ("range l2 d3 k32", kitti[rows], none(ROWS, kitti), kitti, "l2", 32,
         0.01),
        ("range l2 d3 k300", kitti[rows[:512]], none(512, kitti), kitti, "l2",
         300, 0.01),
        ("l2 d2 k1 self", porto[prow], ids(prow), porto, "l2", 1, 1e-6),
        ("l2 d16 k64 self", wide[wrow], ids(wrow), wide, "l2", 64, 20.0),
        ("l1 d3 k300", sub[srow] + 0.01, none(512, sub), sub, "l1", 300, 0.5),
        ("linf d3 k8 self", sub[srow], ids(srow), sub, "linf", 8, 0.1),
    ]
    sub_n = l2_normalize(sub)
    cases.append(("cosine d3 k64", sub_n[srow + 7], none(512, sub), sub_n,
                  "l2", 64, 2.0 * 0.001))
    # the placed fabric's squared L2 past d = 8 (the diff chain), on a cloud
    # of its own seed so the shared draws of later phases stay as they were
    wide12 = torch.as_tensor(np.random.default_rng(12).normal(
        size=(N_WIDE, 12)).astype(np.float32), device=dev)
    cases.append(("l2diff d12 k9", wide12[wrow] + 0.01, none(512, wide12),
                  wide12, "l2diff", 9, 20.0))
    # exact duplicates of point 5 on both sides of every range boundary of
    # the kernel's own split: equal distances across two ranges, which the
    # merge must give to the lower index
    _, span = split_plan(512, N_SUB, 3, 8, "l2", dev)
    tie = sub.clone()
    for b in range(span, N_SUB, span):
        tie[b - 1] = tie[5]
        tie[b] = tie[5]
    cases += [
        ("split ties l2 d3 k8 self", tie[srow], ids(srow), tie, "l2", 8,
         0.05),
        ("split ties l2 d3 k300", tie[srow], none(512, tie), tie, "l2", 300,
         0.05),
    ]
    worst = 0.0
    for tag, q, qid, p, metric, k, thr in cases:
        q = q.contiguous()
        got = topk_engine(q, qid, p, thr, k=k, metric=metric)
        want = pairwise_topk_ref(q, p, k, radius2=thr, query_ids=qid,
                                 metric=metric)
        torch.cuda.synchronize()
        bitwise = p.shape[1] <= 8 or metric != "l2"
        err = compare_topk(tag, got, want, q, p, metric, bitwise)
        worst = max(worst, err)
        s_used = split_plan(q.shape[0], p.shape[0], p.shape[1], k, metric,
                            dev)[0]
        if tag in ("sampler l2 d3 k5", "range l2 d3 k300") or "ties" in tag:
            check(s_used > 1, f"{tag}: the split path was not taken")
        log(f"  pairwise_topk {tag}: Q={q.shape[0]} N={p.shape[0]} S={s_used} "
            f"{'bitwise' if bitwise else 'rtol 1e-6'} ok, max|err|={err:g}, "
            f"counts max {int(got[2].max())}")

    # row_mask: masked rows equal the plain version's, the others untouched
    q, qid = kitti[rows].contiguous(), none(ROWS, kitti)
    for tag, mask in (
        ("all zero", torch.zeros(ROWS, dtype=torch.uint8, device=dev)),
        ("every third row",
         (torch.arange(ROWS, device=dev) % 3 == 0).to(torch.uint8)),
    ):
        res = []
        for fn in ("kernel", "plain"):
            out = (torch.full((ROWS, 32), -1.0, device=dev),
                   torch.full((ROWS, 32), -1, dtype=torch.int32, device=dev),
                   torch.full((ROWS,), -1, dtype=torch.int32, device=dev))
            if fn == "kernel":
                topk_engine(q, qid, kitti, 0.01, k=32, row_mask=mask, out=out)
            else:
                pairwise_topk_ref(q, kitti, 32, radius2=0.01, query_ids=qid,
                                  row_mask=mask, out=out)
            res.append(out)
        torch.cuda.synchronize()
        for a, b, name in zip(*res, ("d", "idx", "counts")):
            check(torch.equal(a, b), f"row_mask {tag}: {name} differs")
        untouched = bool((res[0][2][mask == 0] == -1).all())
        check(untouched, f"row_mask {tag}: an unmasked row was written")
        log(f"  pairwise_topk row_mask {tag}: Q={ROWS} k=32 bitwise ok, "
            f"{int((mask == 0).sum())} rows untouched")
    return worst


# -- phase 3: grid round ----------------------------------------------------


def phase_grid(dev, kitti_np, rng):
    import torch

    from repro_torch import build_index
    from repro_torch.core.fixed_radius import (
        cell_keys,
        grid_round,
        grid_round_plain,
    )
    from repro_torch.core.fused_loop import build_schedule

    index = build_index(kitti_np, backend="trueknn", device=dev)
    r0, _ = index._start_radius(None)
    index._set_anchor(r0)
    sched = build_schedule(index, r0)
    pts = index._pts_t
    rows = torch.as_tensor(
        np.sort(rng.choice(len(kitti_np), GRID_ROWS, replace=False)),
        device=dev,
    )
    q = pts[rows].contiguous()
    qid = rows.to(torch.int32)
    k = 8
    worst = 0.0
    # the first three grids on every row of the subset; then, on
    # DEGEN_ROWS of them (the plain version gathers 3^d * cap slots a row;
    # enough rows for several blocks of the coarse design),
    # the grid whose stencil walks the most slots (the collapsed grid where
    # most of the main path's tests go) and the coarsest (largest cap)
    slots = [math.prod(min(3, r) for r in g.res) * g.cap for g in sched.grids]
    heaviest = max(range(len(slots)), key=slots.__getitem__)
    coarsest = max(range(len(slots)), key=lambda t: sched.grids[t].cap)
    for t, m in ((0, GRID_ROWS), (1, GRID_ROWS), (2, GRID_ROWS),
                 (heaviest, DEGEN_ROWS), (coarsest, DEGEN_ROWS)):
        grid = sched.grids[t]
        r2 = float(np.float32(sched.radii[t]) ** 2)
        res = []
        for fn in (grid_round, grid_round_plain):
            out = (torch.empty((m, k), device=dev),
                   torch.empty((m, k), dtype=torch.int32, device=dev),
                   torch.empty((m,), dtype=torch.int32, device=dev))
            tests = torch.zeros(1, dtype=torch.int64, device=dev)
            fn(pts, grid, q[:m], qid[:m], r2, k, out=out, tests=tests)
            res.append((out, tests))
        torch.cuda.synchronize()
        (a, ta), (b, tb) = res
        for x, y, name in zip(a, b, ("d2", "idx", "found")):
            check(torch.equal(x, y), f"grid round {t}: {name} differs")
        check(ta.item() == tb.item(), f"grid round {t}: n_tests differ")
        fin = torch.isfinite(b[0])
        if fin.any():
            worst = max(worst, float((a[0][fin] - b[0][fin]).abs().max()))
        log(f"  grid_round t={t} rows={m} r={sched.radii[t]:.6g} "
            f"res={grid.res} cap={grid.cap} H={grid.table_size}: bitwise ok, "
            f"n_tests={ta.item()}, found max {int(a[2].max())}")

    # fused mode on the heaviest grid: a partly cleared unres mask, once with
    # the rows as drawn and once with them deliberately out of cell order
    # (alternating between the first and the last cells of the sort)
    grid = sched.grids[heaviest]
    r2 = float(np.float32(sched.radii[heaviest]) ** 2)
    m = DEGEN_ROWS
    order = torch.argsort(cell_keys(q[:m], grid), stable=True)
    mixed = torch.stack([order[: m // 2], order[m // 2:].flip(0)], 1).flatten()
    names = ("d2", "idx", "found", "n_tests", "unres", "res_round", "executed")
    for tag, sel in (("unres partly cleared", torch.arange(m, device=dev)),
                     ("rows out of cell order", mixed)):
        qq, qi = q[sel].contiguous(), qid[sel].contiguous()
        unres0 = (torch.arange(m, device=dev) % 3 != 0).to(torch.uint8)
        res = []
        for fn in (grid_round, grid_round_plain):
            out = (torch.full((m, k), -1.0, device=dev),
                   torch.full((m, k), -1, dtype=torch.int32, device=dev),
                   torch.full((m,), -1, dtype=torch.int32, device=dev))
            state = (torch.zeros(1, dtype=torch.int64, device=dev),
                     unres0.clone(),
                     torch.full((m,), -1, dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev))
            fn(pts, grid, qq, qi, r2, k, out=out, tests=state[0],
               unres=state[1], res_round=state[2], t=heaviest,
               executed=state[3])
            res.append(out + state)
        torch.cuda.synchronize()
        for x, y, name in zip(*res, names):
            check(torch.equal(x, y), f"fused heaviest {tag}: {name} differs")
        log(f"  grid_round fused t={heaviest} rows={m} ({tag}): d2, idx, "
            f"found, n_tests, unres, res_round, executed bitwise ok, "
            f"n_tests={res[0][3].item()}, resolved "
            f"{int((res[0][5] == heaviest).sum())}")
    heavy = (sched.grids[heaviest], sched.radii[heaviest], heaviest)
    return (sched, pts), worst, heavy


# -- phase 4: the main path ---------------------------------------------------


def phase_main(dev, kitti_np, rng):
    import torch

    from repro_torch import KnnSpec, build_index
    from repro_torch.core.result import strip_self_knn
    from repro_torch.kernels import build

    build.reset_launches()
    t0 = time.perf_counter()
    index = build_index(kitti_np, backend="trueknn", device=dev)
    batches = []
    for b in (1, 2):
        t1 = time.perf_counter()
        res = index.query(None, KnnSpec(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        batches.append(res)
        tail = sum(r.n_queries for r in res.rounds if math.isinf(r.radius))
        log(f"  batch {b}: start={res.timings['start_radius_source']} "
            f"r0={res.start_radius:.6g} rounds={res.n_rounds} "
            f"grid_builds={res.timings['grid_builds']} "
            f"grid_cache_hits={res.timings['grid_cache_hits']} "
            f"grid_build_s={res.timings['grid_build_seconds']:.3f} "
            f"n_tests={res.n_tests} brute_tail_rows={tail} "
            f"wall_s={wall:.4f}")
        for r in res.rounds:
            log(f"    round {r.round_idx}: r={r.radius:.6g} res={r.grid_res} "
                f"cap={r.grid_cap} rows={r.n_queries} "
                f"resolved={r.n_resolved} n_tests={r.n_tests}")
    counts = build.launch_counts()
    log(f"  main path built+served in {time.perf_counter() - t0:.2f}s, "
        f"launches {counts}")
    for name in ("grid_round", "pairwise_topk"):
        check(counts[name] > 0, f"main path never launched {name}")
    b1, b2 = batches
    check(b1.timings["start_radius_source"] == "sampled", "batch 1 sampled")
    check(b2.timings["start_radius_source"] == "warm", "batch 2 warm")
    check(b2.timings["grid_builds"] == 0, "batch 2 built no grid")
    check(b2.timings["grid_cache_hits"] > 0, "batch 2 hit the grid cache")
    for res in batches:
        check(res.dists.shape == (N_MAIN, 8), "answer shape")
        check(np.isfinite(res.dists).all(), "finite answers")
        check(not (res.idxs == np.arange(N_MAIN)[:, None]).any(),
              "self excluded")

    rows = np.sort(rng.choice(N_MAIN, ROWS, replace=False))
    brute = build_index(kitti_np, backend="brute", device=dev)
    ref = brute.query(kitti_np[rows], KnnSpec(9))
    bd, bi = strip_self_knn(ref.dists, ref.idxs, rows, 8, N_MAIN)
    hold_rows("trueknn", b2.dists[rows], b2.idxs[rows], bd, bi, kitti_np,
              rows)
    radius = float(np.median(b2.dists[:, 7]))
    return index, batches, counts, radius


def hold_rows(tag, gd, gi, bd, bi, pts, rows):
    """Self-query rows against the brute backend's: distances bitwise,
    index sets equal or tied by distance."""
    check(np.array_equal(gd, bd), f"{tag} vs brute distances")
    same_set = 0
    for r in range(len(rows)):
        a, b = gi[r][gi[r] < len(pts)], bi[r][bi[r] < len(pts)]
        if set(a.tolist()) == set(b.tolist()):
            same_set += 1
            continue
        pa = np.sort(((pts[a] - pts[rows[r]]) ** 2).sum(-1))
        pb = np.sort(((pts[b] - pts[rows[r]]) ** 2).sum(-1))
        np.testing.assert_allclose(pa, pb, rtol=1e-6)  # tied distances
    log(f"  {len(rows)} rows vs brute backend: distances bitwise, index "
        f"sets equal on {same_set} rows, the rest tied by distance")


# -- phase 5: brute range -----------------------------------------------------


def phase_range(dev, kitti_np, radius, rng):
    import torch

    from repro_torch import RangeSpec, build_index
    from repro_torch.api.planner import range_from_counted_round
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import sqrt32
    from repro_torch.kernels.ref import pairwise_topk_ref

    rows = np.sort(rng.choice(N_MAIN, ROWS, replace=False))
    q_np = kitti_np[rows]
    build.reset_launches()
    brute = build_index(kitti_np, backend="brute", device=dev)
    t0 = time.perf_counter()
    res = brute.query(q_np, RangeSpec(radius))
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    check(counts["pairwise_topk"] > 0, "range path never launched the kernel")
    log(f"  RangeSpec({radius:.6g}) on {ROWS} rows: nnz={len(res.idxs)} "
        f"max row={int(res.counts.max())} passes="
        f"{res.timings['count_rounds']} wall_s={wall:.4f} launches {counts}")

    p = brute._pts_t
    q = torch.as_tensor(q_np, device=dev)
    qid = torch.full((ROWS,), N_MAIN, dtype=torch.int32, device=dev)
    thr = float(np.float32(radius) ** 2)

    def plain_round(k):
        d, i, c = pairwise_topk_ref(q, p, int(k), radius2=thr, query_ids=qid)
        return (sqrt32(d).cpu().numpy(), i.cpu().numpy(), c.cpu().numpy(),
                ROWS * N_MAIN)

    want = range_from_counted_round(
        plain_round, q_total=ROWS, cap=N_MAIN, spec=RangeSpec(radius),
        backend="brute",
    )
    check(np.array_equal(res.offsets, want.offsets), "range offsets")
    for r in range(ROWS):
        gi, gd = res.neighbors(r)
        wi, wd = want.neighbors(r)
        check(np.array_equal(np.sort(gi), np.sort(wi)), f"range row {r} set")
        np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=0)
    bitwise = np.array_equal(res.dists, want.dists)
    log(f"  CSR equals the plain version's (offsets and sets exact, "
        f"distances {'bitwise' if bitwise else 'within rtol 1e-6'})")
    err = float(np.abs(res.dists - want.dists).max()) if len(res.dists) else 0.0
    return counts, q, qid, thr, err, (rows, res)


# -- phase 6: the heavy-tailed 2-D cloud ------------------------------------


def phase_porto(dev, rng):
    import torch

    from repro_torch import KnnSpec, build_index, make_dataset

    pts = make_dataset("porto", N_PORTO)
    index = build_index(pts, backend="trueknn", fused=True, device=dev)
    t0 = time.perf_counter()
    res = index.query(None, KnnSpec(8))
    torch.cuda.synchronize()
    log(f"  porto self-query: rounds={res.n_rounds} n_tests={res.n_tests} "
        f"grid_build_s={res.timings['grid_build_seconds']:.3f} "
        f"wall_s={time.perf_counter() - t0:.4f}")
    for r in res.rounds:
        log(f"    round {r.round_idx}: r={r.radius:.6g} res={r.grid_res} "
            f"cap={r.grid_cap} rows={r.n_queries} resolved={r.n_resolved} "
            f"n_tests={r.n_tests}")
    check(np.isfinite(res.dists).all() and res.dists.shape == (N_PORTO, 8),
          "porto answers")
    rows = np.sort(rng.choice(N_PORTO, ROWS, replace=False))
    q = pts[rows] + np.float32(1e-4)
    fused = build_index(pts, backend="trueknn", fused=True,
                        device=dev).query(
        q, KnnSpec(8))
    host = build_index(pts, backend="trueknn", fused=False,
                       device=dev).query(
        q, KnnSpec(8))
    for key in ("dists", "idxs", "found"):
        check(np.array_equal(getattr(fused, key), getattr(host, key)),
              f"fused vs host {key}")
    strip = lambda rs: [(r.round_idx, r.radius, r.n_queries, r.n_resolved,  # noqa: E731
                         r.n_tests, r.grid_res, r.grid_cap, r.cache_hit)
                        for r in rs]
    check(strip(fused.rounds) == strip(host.rounds), "fused vs host rounds")
    log(f"  {ROWS}-row query: fused == host loop ({fused.n_rounds} rounds, "
        f"answers and RoundStats equal)")


# -- phase 7: times against bounds -------------------------------------------


def phase_times(dev, index, b1, q, qid, thr, heavy, rng):
    import torch

    from repro_torch.core.fixed_radius import grid_round, grid_round_plain
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import topk_engine
    from repro_torch.kernels.pairwise_topk import split_plan
    from repro_torch.kernels.ref import pairwise_topk_ref

    sync = torch.cuda.synchronize
    p = index._pts_t
    n, d = p.shape
    ext = build.extension()

    def split_ms(qq, qi, k, t):
        """The two passes of one pairwise_topk call timed apart: (S, first
        pass ms, merge ms)."""
        nq = qq.shape[0]
        splits, span = split_plan(nq, n, d, k, "l2", dev)
        part = (torch.empty((splits, nq, k), device=dev),
                torch.empty((splits, nq, k), dtype=torch.int32, device=dev),
                torch.empty((splits, nq), dtype=torch.int32, device=dev))
        outs = tuple(x[0] for x in part)
        t1 = median_ms(lambda: ext.pairwise_topk(
            qq, qi, p, None, k, splits, span, t, 0, *part), 3, sync)
        t2 = (median_ms(lambda: ext.pairwise_topk_merge(
            *part, None, n, *outs), 3, sync) if splits > 1 else 0.0)
        return splits, t1, t2

    k = 32
    t_k = median_ms(lambda: topk_engine(q, qid, p, thr, k=k), 3, sync)
    t_p = median_ms(lambda: pairwise_topk_ref(q, p, k, radius2=thr,
                                              query_ids=qid), 1, sync,
                    warmup=False)
    qn = q.shape[0]
    pw_bytes = qn * d * 4 + n * d * 4 + qn * 4 + qn * k * 8 + qn * 4
    pw_flops = qn * n * 3 * d
    pw_bound = bound(pw_bytes, pw_flops)
    pw_split = split_ms(q, qid, k, thr)
    log(f"  pairwise_topk Q={qn} N={n} k={k}: kernel {t_k:.3f} ms "
        f"(S={pw_split[0]}: first pass {pw_split[1]:.3f} ms, merge "
        f"{pw_split[2]:.3f} ms), plain {t_p:.3f} ms, bound "
        f"{pw_bound[0]:.4f} ms ({pw_bound[1]})")

    # the Alg. 2 sampler's call: 100 member rows, k = 5, no radius
    samp = torch.as_tensor(rng.choice(n, 100, replace=False), device=dev)
    qs = p[samp].contiguous()
    qid_s = torch.full((100,), n, dtype=torch.int32, device=dev)
    ks = 5
    s_k = median_ms(lambda: topk_engine(qs, qid_s, p, math.inf, k=ks), 3,
                    sync)
    s_p = median_ms(lambda: pairwise_topk_ref(qs, p, ks, query_ids=qid_s), 3,
                    sync)
    s_bound = bound(100 * d * 4 + n * d * 4 + 100 * 4 + 100 * ks * 8
                    + 100 * 4, 100 * n * 3 * d)
    s_split = split_ms(qs, qid_s, ks, math.inf)
    log(f"  pairwise_topk Q=100 N={n} k={ks} (sampler): kernel {s_k:.3f} ms "
        f"(S={s_split[0]}: first pass {s_split[1]:.3f} ms, merge "
        f"{s_split[2]:.3f} ms), plain {s_p:.3f} ms, bound {s_bound[0]:.4f} ms"
        f" ({s_bound[1]})")

    # round 0 of batch 1: every row of the cloud runs (the plain version
    # of a later, coarser round would take hours at this width)
    grid, _ = index._grid_for(b1.start_radius)
    qid_all = torch.arange(n, dtype=torch.int32, device=dev)
    r2 = float(np.float32(b1.start_radius) ** 2)
    kk = 8
    out = (torch.empty((n, kk), device=dev),
           torch.empty((n, kk), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev))
    out_p = tuple(torch.empty_like(t) for t in out)
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    tests_p = torch.zeros(1, dtype=torch.int64, device=dev)

    def run(fn, o, t, g=grid, rr=r2):
        t.zero_()
        fn(p, g, p, qid_all, rr, kk, out=o, tests=t)

    g_k = median_ms(lambda: run(grid_round, out, tests), 3, sync)
    g_p = median_ms(lambda: run(grid_round_plain, out_p, tests_p), 1, sync,
                    warmup=False)
    n_tests = int(tests.item())
    for x, y, name in zip(out, out_p, ("d2", "idx", "found")):
        check(torch.equal(x, y), f"grid round at full width: {name} differs")
    check(n_tests == int(tests_p.item()), "full-width n_tests differ")
    # a self-query: the queries are the points, so the cloud is read once
    # (points, buckets, cell coords, ids in; d2 + idx, found out)
    g_bytes = (n * d * 4 + grid.table_size * grid.cap * 4 + (n + 1) * d * 4
               + n * 4 + n * kk * 8 + n * 4)
    g_bound = bound(g_bytes, n_tests * 3 * d)
    log(f"  grid_round Q={n} r={b1.start_radius:.6g} cap={grid.cap} "
        f"H={grid.table_size} n_tests={n_tests}: bitwise equal to the plain "
        f"version; kernel {g_k:.3f} ms, plain {g_p:.3f} ms, bound "
        f"{g_bound[0]:.4f} ms ({g_bound[1]})")

    # the heaviest scheduled grid at full width, one non-fused launch (the
    # plain version would take hours here: n_tests is held to its exact
    # value instead, N * N on a grid of res <= 2 per axis)
    hgrid, hrad, ht = heavy
    hr2 = float(np.float32(hrad) ** 2)
    heavy_run = lambda: run(grid_round, out, tests, hgrid, hr2)  # noqa: E731
    first = median_ms(heavy_run, 1, sync, warmup=False)
    h_k = first if first > 2000.0 else median_ms(heavy_run, 3, sync,
                                                 warmup=False)
    h_tests = int(tests.item())
    if max(hgrid.res) <= 2:
        check(h_tests == n * n, f"heaviest round n_tests {h_tests} != N*N")
    h_bytes = (n * d * 4 + hgrid.table_size * hgrid.cap * 4
               + (n + 1) * d * 4 + n * 4 + n * kk * 8 + n * 4)
    h_bound = bound(h_bytes, h_tests * 3 * d)
    log(f"  grid_round heaviest t={ht} Q={n} r={hrad:.6g} res={hgrid.res} "
        f"cap={hgrid.cap} H={hgrid.table_size} n_tests={h_tests}: kernel "
        f"{h_k:.3f} ms (first launch {first:.3f} ms), plain not run, bound "
        f"{h_bound[0]:.4f} ms ({h_bound[1]})")
    return ((t_k, t_p, pw_bound, pw_split), (s_k, s_p, s_bound, s_split),
            (g_k, g_p, g_bound),
            (h_k, None, h_bound, h_tests))


# -- phase 8: the two grid_round designs on every scheduled grid ------------


def _events_ms(fn):
    """Device time of one call of ``fn`` in ms (CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _design_ms(pts, grid, r2, state, tiled):
    """Median time of one launch of one design on fresh copies of
    ``state`` (d2, idx, found and, fused, unres and res_round; the cell-key
    sort of the coarse design included), and the state it leaves."""
    import torch

    from repro_torch.core.fixed_radius import _launch

    n, k = state[0].shape
    qid = torch.arange(n, dtype=torch.int32, device=pts.device)
    times, st = [], None
    for _ in range(3):
        st = [x.clone() for x in state] + [
            torch.zeros(1, dtype=torch.int64, device=pts.device),
            torch.zeros(1, dtype=torch.int32, device=pts.device)]
        fused = len(state) == 5
        torch.cuda.synchronize()
        times.append(_events_ms(lambda: _launch(
            pts, grid, pts, qid, r2, k, tiled, out=tuple(st[:3]),
            tests=st[-2], unres=st[3] if fused else None,
            res_round=st[4] if fused else None, t=0,
            executed=st[-1] if fused else None)))
        if times[-1] > 200.0:
            break
    return statistics.median(times), st


def phase_designs(dev, kitti):
    """Both designs of ``grid_round`` on every scheduled grid of four
    clouds, self-queries at k = 8: each round of the fused loop as the
    main path runs it (on the rows still unresolved), and every row once
    on each grid shape whose cap lies between the fine grids' and the
    collapsed ones'.  The designs must agree bitwise; the fine design is not run
    where its tests would pass ``FINE_TEST_BUDGET`` (on a res (2, 2, 2)
    grid of 2^20 points it takes about 20 s).  ``kitti`` is phase 3's
    (schedule, points).  Returns the totals for the kernels line."""
    import torch

    from repro_torch import build_index, make_dataset
    from repro_torch.core.fixed_radius import coarse_design, stencil_slots
    from repro_torch.core.fused_loop import build_schedule

    tot = {"fused": [0.0] * 4, "all rows": [0.0] * 4}
    for cloud, n in (("kitti", N_MAIN), ("porto", N_PORTO),
                     ("road", N_MAIN), ("uniform", N_MAIN)):
        if cloud == "kitti":
            sched, pts = kitti
        else:
            index = build_index(make_dataset(cloud, n), backend="trueknn",
                                device=dev)
            r0, _ = index._start_radius(None)
            index._set_anchor(r0)
            sched, pts = build_schedule(index, r0), index._pts_t
        k = 8
        # fused_search's state: d2, idx, found, unres, res_round
        fused = [torch.full((n, k), math.inf, device=dev),
                 torch.full((n, k), n, dtype=torch.int32, device=dev),
                 torch.zeros(n, dtype=torch.int32, device=dev),
                 torch.isfinite(pts[:, 0]).to(torch.uint8),
                 torch.full((n,), -1, dtype=torch.int32, device=dev)]
        seen = set()
        for t, grid in enumerate(sched.grids):
            r2 = float(np.float32(sched.radii[t]) ** 2)
            modes = [("fused", fused)]
            shape = (grid.res, grid.cap, grid.table_size)
            if 16 < grid.cap < (1 << 19) and shape not in seen:
                seen.add(shape)
                modes.append(("all rows", [torch.empty_like(x)
                                           for x in fused[:3]]))
            for mode, state in modes:
                rows = int(state[3].sum()) if mode == "fused" else n
                if rows == 0:
                    continue
                c_ms, c_st = _design_ms(pts, grid, r2, state, True)
                n_tests = int(c_st[-2].item())
                f_ms = None
                if n_tests <= FINE_TEST_BUDGET:
                    f_ms, f_st = _design_ms(pts, grid, r2, state, False)
                    for x, y in zip(c_st, f_st):
                        check(torch.equal(x, y), f"designs differ: {cloud} "
                              f"t={t} {mode}")
                pick = coarse_design(grid)
                if f_ms is not None:
                    acc = tot[mode]
                    for j, v in enumerate((c_ms if pick else f_ms,
                                           min(c_ms, f_ms), f_ms, c_ms)):
                        acc[j] += v
                fine = "not run" if f_ms is None else f"{f_ms:.3f} ms"
                log(f"  {cloud} t={t} {mode}: rows={rows} res={grid.res} "
                    f"cap={grid.cap} H={grid.table_size} "
                    f"slots={stencil_slots(grid):.6g} n_tests={n_tests}: "
                    f"coarse {c_ms:.3f} ms, fine {fine}; the wrapper takes "
                    f"{'coarse' if pick else 'fine'}")
                if mode == "fused":
                    fused = c_st[:5]
        del sched, pts, fused
        torch.cuda.empty_cache()
    summary = {}
    for mode, (picked, best, fine, coarse) in tot.items():
        log(f"  {mode}, over the rounds both designs ran: the wrapper's "
            f"picks {picked:.3f} ms, the faster design each round "
            f"{best:.3f} ms, always fine {fine:.3f} ms, always coarse "
            f"{coarse:.3f} ms")
        summary[mode] = {"picked_ms": picked, "best_ms": best,
                         "fine_ms": fine, "coarse_ms": coarse}
    return summary

# -- phases 9-11: the other backends, routes and workloads ----------------


TOL = 1e-4  # the reference's tolerance for float32 engines vs an oracle


def counted(tag, fn, tally, need=("grid_round",)):
    """Run one entry point with the launch counts zeroed just before and
    read just after; fails if a kernel of its path was not launched.
    Returns (result, host seconds to a device sync, counts) and adds the
    counts to ``tally``."""
    import torch

    from repro_torch.kernels import build

    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for name in need:
        check(counts[name] > 0, f"{tag}: never launched {name}")
    for name, c in counts.items():
        tally[name] += c
    return out, wall, counts


def same_arrays(tag, a, b, keys):
    for key in keys:
        check(np.array_equal(getattr(a, key), getattr(b, key)),
              f"{tag}: {key} differs")


def same_csr_up_to_ties(tag, a, b):
    """Two range CSRs: offsets and dists bitwise, idxs bitwise once each
    row is ordered by (dist, idx).  A grid round orders neighbors at equal
    distance by their slot in its grid (the reference's rule), so two
    grids of other shapes may list tied neighbors in another order.
    Returns the number of rows whose idxs differ before that ordering."""
    same_arrays(tag, a, b, ("offsets", "dists"))
    rows = np.repeat(np.arange(a.n_queries), a.counts)
    ia = a.idxs[np.lexsort((a.idxs, a.dists, rows))]
    ib = b.idxs[np.lexsort((b.idxs, b.dists, rows))]
    check(np.array_equal(ia, ib), f"{tag}: idxs differ beyond tie order")
    return len(np.unique(rows[a.idxs != b.idxs]))


def counted_k(res):
    """The k of a counted range's last round (``range_from_counted_round``:
    32, then the next power of two of the fullest ball)."""
    top = int(res.counts.max()) if res.n_queries else 0
    return 32 if top <= 32 else 1 << (top - 1).bit_length()


def phase_fixed_radius(dev, kitti_np, radius, range5, rng, tally):
    from repro_torch import HybridSpec, KnnSpec, RangeSpec, build_index
    from repro_torch.core.result import strip_self_knn

    index = build_index(kitti_np, backend="fixed_radius", radius=radius,
                        device=dev)
    hyb = []
    for b in (1, 2):
        res, wall, counts = counted(
            f"fixed_radius hybrid batch {b}",
            lambda: index.query(None, HybridSpec(8, radius)), tally)
        hyb.append(res)
        log(f"  HybridSpec(8, {radius:.6g}) self-query batch {b}: "
            f"grid_builds={res.timings['grid_builds']} grid_cache_hits="
            f"{res.timings['grid_cache_hits']} grid={res.rounds[0].grid_res} "
            f"cap={res.rounds[0].grid_cap} n_tests={res.n_tests} rows with k "
            f"in the ball {int((res.found >= 8).sum())} wall_s={wall:.4f} "
            f"launches {counts}")
    h1, h2 = hyb
    check(h1.timings["grid_builds"] == 1, "batch 1 built the grid")
    check(h2.timings["grid_builds"] == 0
          and h2.timings["grid_cache_hits"] == 1, "batch 2 hit the grid")
    same_arrays("fixed_radius batches", h1, h2, ("dists", "idxs", "found"))
    check(h2.dists.shape == (N_MAIN, 8), "answer shape")
    check(not (h2.idxs == np.arange(N_MAIN)[:, None]).any(), "self excluded")
    knn, wall, _ = counted("fixed_radius knn",
                           lambda: index.query(None, KnnSpec(8)), tally)
    same_arrays("KnnSpec(8) with the cfg radius vs the hybrid", knn, h2,
                ("dists", "idxs", "found"))
    log(f"  KnnSpec(8) at the cfg radius equals the hybrid bitwise "
        f"(wall_s={wall:.4f})")

    rows = np.sort(rng.choice(N_MAIN, ROWS, replace=False))
    brute = build_index(kitti_np, backend="brute", device=dev)
    ref = brute.query(kitti_np[rows], HybridSpec(9, radius))
    bd, bi = strip_self_knn(ref.dists, ref.idxs, rows, 8, N_MAIN)
    hold_rows("fixed_radius", h2.dists[rows], h2.idxs[rows], bd, bi,
              kitti_np, rows)

    rows5, want = range5
    got, wall, counts = counted(
        "fixed_radius range",
        lambda: index.query(kitti_np[rows5], RangeSpec(radius)), tally)
    same_arrays("fixed_radius RangeSpec vs phase 5's brute CSR", got, want,
                ("offsets", "idxs", "dists"))
    log(f"  RangeSpec({radius:.6g}) on phase 5's {ROWS} rows: CSR bitwise "
        f"equal to the brute backend's (nnz={len(got.idxs)}, passes="
        f"{got.timings['count_rounds']}, counted-round k={counted_k(got)}, "
        f"wall_s={wall:.4f}, launches {counts})")
    return index


def _tied_or_equal(tag, got, want, q, pts, metric):
    """Index rows equal, or the two sets' float64 distances within TOL."""
    from repro_torch.api import get_metric

    m = get_metric(metric)
    same = 0
    for r in range(q.shape[0]):
        if np.array_equal(got.idxs[r], want.idxs[r]):
            same += 1
            continue
        for ids in (got.idxs[r], want.idxs[r]):
            check(np.all(ids < N_MAIN), f"{tag}: row {r} short")
        da = np.sort(m.pairwise(q[r:r + 1], pts[got.idxs[r]])[0])
        db = np.sort(m.pairwise(q[r:r + 1], pts[want.idxs[r]])[0])
        np.testing.assert_allclose(da, db, rtol=TOL, atol=TOL)
    return same


def _hybrid_within_tol(tag, got, knn_d, r):
    """The reference's hybrid check (``tests/test_query.py``): against the
    exact kNN distances, every certainly-inside neighbor is found, no
    certainly-outside one is, and the finite distances agree to TOL."""
    srt = np.sort(knn_d, 1)
    nf = np.isfinite(got.dists).sum(1)
    lo = (srt <= r - TOL).sum(1)
    hi = (srt <= r + TOL).sum(1)
    check(bool(np.all((lo <= nf) & (nf <= hi))), f"{tag}: ball counts")
    fin = np.arange(srt.shape[1])[None, :] < nf[:, None]
    np.testing.assert_allclose(np.sort(got.dists, 1)[fin], srt[fin],
                               rtol=TOL, atol=TOL)


def phase_routes(dev, kitti_np, tk_index, fr_index, rng, tally):
    """The generic routes on 4096 rows, each held against the brute
    backend's native answer."""
    from repro_torch import HybridSpec, KnnSpec, RangeSpec, build_index

    rows = np.sort(rng.choice(N_MAIN, ROWS, replace=False))
    q = kitti_np[rows]
    brute = build_index(kitti_np, backend="brute", device=dev)
    cos_ref = brute.query(q, KnnSpec(8), metric="cosine")
    r_cos = float(np.median(cos_ref.dists[:, 7]))
    linf_knn = brute.query(q, KnnSpec(8), metric="linf")
    r_inf = float(np.median(linf_knn.dists[:, 7]))
    both = ("grid_round", "pairwise_topk")
    routes = (
        ("trueknn", tk_index, "cosine", KnnSpec(8), "l2_view", both),
        ("trueknn", tk_index, "l1", KnnSpec(8), "brute_metric",
         ("pairwise_topk",)),
        ("trueknn", tk_index, "linf", RangeSpec(r_inf), "brute_metric",
         ("pairwise_topk",)),
        ("fixed_radius", fr_index, "cosine", HybridSpec(8, r_cos), "l2_view",
         ("grid_round",)),
    )
    secs = {}
    for backend, index, metric, spec, route, need in routes:
        tag = f"{backend} {metric} {spec.kind}"
        res, wall, counts = counted(
            tag, lambda: index.query(q, spec, metric=metric), tally, need)
        check(res.timings["plan"] == route, f"{tag}: plan "
              f"{res.timings['plan']!r}, not {route!r}")
        check(res.backend == backend and res.metric == metric,
              f"{tag}: backend/metric tags")
        want = brute.query(q, spec, metric=metric)
        if metric == "l1":
            same_arrays(tag, res, want, ("dists", "idxs"))
            how = "bitwise"
        elif metric == "linf":
            same_arrays(tag, res, want, ("offsets", "idxs", "dists"))
            how = (f"CSR bitwise, nnz={len(res.idxs)}, passes="
                   f"{res.timings['count_rounds']}, counted-round k="
                   f"{counted_k(res)}")
        elif isinstance(spec, KnnSpec):
            np.testing.assert_allclose(res.dists, want.dists, rtol=TOL,
                                       atol=TOL)
            same = _tied_or_equal(tag, res, want, q, kitti_np, metric)
            how = (f"distances to {TOL:g}, index rows equal on {same}, the "
                   f"rest tied to {TOL:g}")
        else:
            _hybrid_within_tol(tag, res, cos_ref.dists, spec.radius)
            how = (f"ball counts and distances to {TOL:g} "
                   f"({int(np.isfinite(res.dists).sum())} neighbors)")
        secs[f"{tag} ({route})"] = wall
        log(f"  {tag}: plan={route} backend={backend}, {how} vs brute's "
            f"native {metric}; wall_s={wall:.4f} launches {counts}")
    return secs


def phase_all_pairs(dev, tk_index, fr_index, b2, radius, tally):
    """All-pairs self-queries on both grid backends, the counted range's
    rounds timed at full width, then the kNN graph and DBSCAN."""
    import torch

    from repro_torch import AllPairsSpec
    from repro_torch.core.fixed_radius import grid_round
    from repro_torch.workloads import build_knn_graph, dbscan

    whole, wall, counts = counted(
        "all_pairs knn", lambda: tk_index.query(None, AllPairsSpec(8)),
        tally)
    check(whole.timings["plan"] == "all_pairs", "all_pairs tag")
    same_arrays("AllPairsSpec(8) vs phase 4's self-query", whole, b2,
                ("dists", "idxs"))
    log(f"  AllPairsSpec(8) on trueknn: equal to phase 4's batch 2 bitwise "
        f"(inner plan {whole.timings.get('plan_inner')}); wall_s={wall:.4f} "
        f"launches {counts}")
    chunk = CHUNK_ROWS
    part, wall, counts = counted(
        "all_pairs chunked",
        lambda: tk_index.query(None, AllPairsSpec(8, chunk_rows=chunk)),
        tally)
    check(part.timings["plan"] == f"all_pairs/chunked={chunk}", "chunk tag")
    same_arrays("chunked all-pairs vs whole", part, whole, ("dists", "idxs"))
    log(f"  AllPairsSpec(8, chunk_rows={chunk}): {part.timings['chunks']} "
        f"chunks, equal to the whole batch bitwise; wall_s={wall:.4f} "
        f"launches {counts}")

    spec = AllPairsSpec(mode="range", radius=radius)
    csr = {}
    for backend, index in (("trueknn", tk_index), ("fixed_radius", fr_index)):
        res, wall, counts = counted(f"all_pairs range {backend}",
                                    lambda: index.query(None, spec), tally)
        check(res.backend == backend and res.timings["plan"] == "all_pairs",
              f"{backend}: all_pairs range tags")
        csr[backend] = res
        log(f"  AllPairsSpec(range, {radius:.6g}) on {backend}: nnz="
            f"{len(res.idxs)} max row={int(res.counts.max())} mean "
            f"{float(res.counts.mean()):.3f} passes="
            f"{res.timings['count_rounds']} counted-round k="
            f"{counted_k(res)} wall_s={wall:.4f} launches {counts}")
    reordered = same_csr_up_to_ties("range all-pairs trueknn vs "
                                    "fixed_radius", csr["trueknn"],
                                    csr["fixed_radius"])
    log(f"  the two CSRs: offsets and dists bitwise equal, idxs bitwise "
        f"equal on all but {reordered} rows, whose neighbors at equal "
        f"distance come in the order of each backend's grid (equal once "
        f"each row is ordered by (dist, idx))")

    # the counted range's two rounds alone, at full width (k > 32 keeps
    # its lists in the output rows)
    pts = fr_index._pts_t
    n, d = pts.shape
    grid, _ = fr_index._grid_for(radius)
    qid = torch.arange(n, dtype=torch.int32, device=dev)
    r2 = float(np.float32(radius) ** 2)
    rounds = []
    for k in (32, counted_k(csr["fixed_radius"])):
        out = (torch.empty((n, k), device=dev),
               torch.empty((n, k), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev))
        tests = torch.zeros(1, dtype=torch.int64, device=dev)

        def run():
            tests.zero_()
            grid_round(pts, grid, pts, qid, r2, k, out=out, tests=tests)

        ms = median_ms(run, 3, torch.cuda.synchronize, warmup=False)
        n_tests = int(tests.item())
        b = bound(n * d * 4 + grid.table_size * grid.cap * 4
                  + (n + 1) * d * 4 + n * 4 + n * k * 8 + n * 4,
                  n_tests * 3 * d)
        rounds.append((k, ms, b, n_tests))
        log(f"  counted range round k={k} Q={n} res={grid.res} cap="
            f"{grid.cap} n_tests={n_tests}: kernel {ms:.3f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]})")
        del out

    graph, graph_s, counts = counted(
        "knn graph", lambda: build_knn_graph(tk_index, 8), tally)
    deg = graph.counts
    check(graph.n == n and graph.n_edges >= n * 8, "graph size")
    log(f"  build_knn_graph(trueknn, 8): nodes={graph.n} edges="
        f"{graph.n_edges} degree min {int(deg.min())} mean "
        f"{float(deg.mean()):.3f} max {int(deg.max())}; wall_s={graph_s:.4f}"
        f" launches {counts}")

    # DBSCAN: the device part is its one range self-query, timed inside
    inner = []
    query = tk_index.query

    def timed_query(*a, **kw):
        t0 = time.perf_counter()
        out = query(*a, **kw)
        torch.cuda.synchronize()
        inner.append(time.perf_counter() - t0)
        return out

    tk_index.query = timed_query
    try:
        clusters, wall, counts = counted(
            "dbscan", lambda: dbscan(tk_index, radius, 8), tally)
    finally:
        del tk_index.query
    check(len(inner) == 1, "dbscan ran one self-query")
    check(clusters.labels.shape == (n,) and clusters.n_clusters > 0,
          "dbscan labels")
    check(np.array_equal(clusters.core,
                         csr["trueknn"].counts + 1 >= 8), "dbscan core mask")
    log(f"  dbscan(trueknn, {radius:.6g}, 8): clusters={clusters.n_clusters}"
        f" core={int(clusters.core.sum())} noise={clusters.n_noise}; "
        f"wall_s={wall:.4f}, of which the range self-query {inner[0]:.4f} s "
        f"and the host union-find and labels {wall - inner[0]:.4f} s; "
        f"launches {counts}")
    return rounds, graph


# -- phases 12-14: the mesh-sharded engines and the sharded backend --------


def knn_up_to_ties(tag, gd, gi, wd, wi, *, dist_tol=None):
    """Two kNN answers: distances bitwise (or to ``dist_tol``), indices
    bitwise once each row is ordered by (dist, idx).  A grid round orders
    neighbors at equal distance by their slot in its grid, the dense
    engines and the shard merges by index.  Returns the number of rows
    whose indices differ before that ordering."""
    if dist_tol is None:
        check(np.array_equal(gd, wd), f"{tag}: distances differ")
    else:
        np.testing.assert_allclose(gd, wd, rtol=dist_tol, atol=dist_tol)
    rows = np.arange(gd.shape[0])[:, None]
    og = np.lexsort((gi, wd, np.broadcast_to(rows, gi.shape)), axis=-1)
    ow = np.lexsort((wi, wd, np.broadcast_to(rows, wi.shape)), axis=-1)
    check(np.array_equal(np.take_along_axis(gi, og, 1),
                         np.take_along_axis(wi, ow, 1)),
          f"{tag}: indices differ beyond tie order")
    return int((gi != wi).any(axis=1).sum())


def phase_distributed(dev, rng, tally):
    """Phase 12: ``backend="distributed"`` on a 4-position model axis, all
    on the one card, over kitti 2^22 (2^20 points a shard), two batches of
    2^16 query rows, held against the brute backend and a one-position
    mesh."""
    from repro_torch import DeviceMesh, KnnSpec, build_index, make_dataset

    n = P_MESH * N_MAIN
    cloud = make_dataset("kitti", n)
    rows = np.sort(rng.choice(n, DIST_ROWS, replace=False))
    q = cloud[rows]
    mesh = DeviceMesh([dev] * P_MESH)
    index = build_index(cloud, backend="distributed", mesh=mesh, device=dev,
                        growth=2.0, max_rounds=MESH_ROUNDS)
    batches = []
    for b in (1, 2):
        res, wall, counts = counted(
            f"distributed batch {b}", lambda: index.query(q, KnnSpec(8)),
            tally, need=("pairwise_topk",))
        batches.append(res)
        log(f"  batch {b}: mesh {mesh.shape} rows={DIST_ROWS} start_r="
            f"{res.start_radius:.6g} rounds={res.timings['mesh_rounds']} "
            f"n_tests={res.n_tests} wall_s={wall:.4f} launches {counts}")
    b1, b2 = batches
    same_arrays("distributed batches", b1, b2, ("dists", "idxs"))
    check(b1.dists.shape == (DIST_ROWS, 8) and np.isfinite(b1.dists).all(),
          "distributed answer shape")
    brute = build_index(cloud, backend="brute", device=dev)
    want = brute.query(q, KnnSpec(8))
    same_arrays("distributed vs brute", b1, want, ("dists", "idxs"))
    one = build_index(cloud, backend="distributed", device=dev,
                      mesh=DeviceMesh([dev]), max_rounds=MESH_ROUNDS)
    t0 = time.perf_counter()
    solo = one.query(q, KnnSpec(8))
    solo_s = time.perf_counter() - t0
    same_arrays("4-position vs 1-position mesh", b1, solo, ("dists", "idxs"))
    log(f"  equal bitwise (distances and indices) to the brute backend "
        f"and to a one-position mesh (rounds={solo.timings['mesh_rounds']}, "
        f"wall_s={solo_s:.4f})")
    hold_position_round0(dev, index, q, b1.start_radius)
    return mesh


def hold_position_round0(dev, index, q, radius):
    """The kernel call of round 0 at the last model position, as
    ``make_distributed_knn`` makes it (all 2^16 rows, the threshold, the
    self ids shifted by the shard's offset), against the plain version on
    the same tensors, bitwise.  At Q = 2^16 the split rule takes S = 1:
    the first pass alone, no merge."""
    import torch

    from repro_torch.kernels.ops import topk_engine
    from repro_torch.kernels.pairwise_topk import split_plan
    from repro_torch.kernels.ref import pairwise_topk_ref

    pos = P_MESH - 1
    pts_l = index._pts_device[pos]
    nl = pts_l.shape[0]
    thr = float(np.float32(radius) ** 2)
    q_l = torch.as_tensor(q, device=dev).contiguous()
    # external queries carry id -1, shifted to -1 - pos * nl here
    qid_l = torch.full((q.shape[0],), -1 - pos * nl, dtype=torch.int32,
                       device=dev)
    s_used = split_plan(q.shape[0], nl, q.shape[1], 8, "l2", dev)[0]
    check(s_used == 1, f"round 0 at Q={q.shape[0]}: S={s_used}, not 1")
    t0 = time.perf_counter()
    got = topk_engine(q_l, qid_l, pts_l, thr, k=8)
    want = pairwise_topk_ref(q_l, pts_l, 8, radius2=thr, query_ids=qid_l)
    torch.cuda.synchronize()
    err = compare_topk(f"position {pos} round 0", got, want, q_l, pts_l, "l2",
                       True)
    log(f"  position {pos} round 0 (Q={q.shape[0]} N={nl} k=8 thr={thr:.6g} "
        f"qid={-1 - pos * nl}, S={s_used}): kernel bitwise equal to the "
        f"plain version (max|err|={err:g}, counts max {int(got[2].max())}, "
        f"{time.perf_counter() - t0:.1f}s)")


def phase_distributed_grid(dev, mesh, rng, tally):
    """Phase 13: ``distributed_trueknn_grid`` on phase 12's mesh over a
    uniform 2^22 cloud and 2^16 of its rows, held against the dense engine
    (``backend="distributed"``) on the same rows.  Not on kitti: the
    stacked grids share one (table_size, cap), the largest over the
    shards, and kitti's shards straddle the sizing probe's collapse (one
    shard asks for a fine table, another for a 2^19 cap), so the shared
    shape needs up to 2^40 slots a shard; on a uniform cloud every shard
    asks for the same shape."""
    from repro_torch import KnnSpec, build_index, make_dataset
    from repro_torch.core.distributed_grid import distributed_trueknn_grid

    n = P_MESH * N_MAIN
    cloud = make_dataset("uniform", n)
    q = cloud[np.sort(rng.choice(n, DIST_ROWS, replace=False))]
    t0 = time.perf_counter()
    dense = build_index(cloud, backend="distributed", mesh=mesh, device=dev,
                        max_rounds=MESH_ROUNDS).query(q, KnnSpec(8))
    log(f"  dense engine on the same rows: rounds="
        f"{dense.timings['mesh_rounds']} n_tests={dense.n_tests} wall_s="
        f"{time.perf_counter() - t0:.4f}")
    (d, i, st), wall, counts = counted(
        "distributed grid",
        lambda: distributed_trueknn_grid(cloud, 8, mesh, queries=q,
                                         max_rounds=MESH_ROUNDS), tally)
    for r in st["rounds"]:
        log(f"    round: r={r['radius']:.6g} rows={r['queries']} resolved="
            f"{r['resolved']} tests={r['tests']} table={r['table']} "
            f"cap={r['cap']}")
    reordered = knn_up_to_ties("grid engine vs dense", d, i, dense.dists,
                               dense.idxs, dist_tol=TOL)
    bitwise = np.array_equal(d, dense.dists)
    check(st["total_tests"] < dense.n_tests,
          "the grid engine tests fewer candidates than the dense one")
    log(f"  {len(st['rounds'])} rounds, total_tests={st['total_tests']} "
        f"(dense: {dense.n_tests}); distances "
        f"{'bitwise' if bitwise else f'to {TOL:g}'} and indices equal to "
        f"the dense engine's up to tie order ({reordered} rows list tied "
        f"neighbors in another order); host grid builds "
        f"{st['grid_build_seconds']:.4f} s of wall_s={wall:.4f}; launches "
        f"{counts}")
    hold_shard_rounds(dev, cloud, q, st)
    return wall, st["grid_build_seconds"]


def hold_shard_rounds(dev, cloud, q, st):
    """The last shard's ``grid_round`` call of round 0 and of the last
    round, as ``make_grid_round`` makes it (a ``Grid`` view of the stacked
    grids at their shared table and cap; the rows padded to a power of two
    with +inf rows; out-of-shard self ids = Nl), against the plain grid
    round on the same view and rows, bitwise."""
    import torch

    from repro_torch.core.distributed_grid import (_shard_grid,
                                                   build_stacked_grids,
                                                   shard_points)
    from repro_torch.core.fixed_radius import grid_round, grid_round_plain

    shards, n_valid = shard_points(cloud, P_MESH)
    s = P_MESH - 1
    nl = shards.shape[1]
    pts_l = torch.as_tensor(shards[s], device=dev)
    k = 8
    for t in (0, len(st["rounds"]) - 1):
        rd = st["rounds"][t]
        grids, table, cap = build_stacked_grids(shards, n_valid,
                                                rd["radius"], device=dev)
        check((table, cap) == (rd["table"], rd["cap"]),
              f"round {t}: stacked shape {(table, cap)} is not the run's")
        grid = _shard_grid(grids, s, table, nl, dev)
        m = rd["queries"]
        m_pad = 1 << max(0, (m - 1).bit_length())
        rows = np.full((m_pad, q.shape[1]), np.inf, np.float32)
        rows[:m] = q[:m]
        q_l = torch.as_tensor(rows, device=dev)
        qid_l = torch.full((m_pad,), nl, dtype=torch.int32, device=dev)
        r2 = float(np.float32(rd["radius"]) ** 2)
        res = []
        for fn in (grid_round, grid_round_plain):
            out = (torch.empty((m_pad, k), device=dev),
                   torch.empty((m_pad, k), dtype=torch.int32, device=dev),
                   torch.empty((m_pad,), dtype=torch.int32, device=dev))
            tests = torch.zeros(1, dtype=torch.int64, device=dev)
            fn(pts_l, grid, q_l, qid_l, r2, k, out=out, tests=tests)
            res.append((out, tests))
        torch.cuda.synchronize()
        (a, ta), (b, tb) = res
        for x, y, name in zip(a, b, ("d2", "idx", "found")):
            check(torch.equal(x, y), f"shard {s} round {t}: {name} differs")
        check(ta.item() == tb.item(), f"shard {s} round {t}: tests differ")
        log(f"  shard {s} round {t} (rows {m} padded to {m_pad}, table "
            f"{table}, cap {cap}, res {grid.res}): grid_round bitwise equal "
            f"to the plain version, tests={ta.item()}, found max "
            f"{int(a[2].max())}")


def phase_sharded(dev, kitti_np, tk_index, b2, range5, radius, rng, tally):
    """Phase 14: ``backend="sharded"`` on the host over kitti 2^20, 8 morton
    shards of trueknn children, each answer held against the monolithic
    trueknn index of phase 4 on the same rows."""
    from repro_torch import (AllPairsSpec, HybridSpec, KnnSpec, RangeSpec,
                             build_index)

    t0 = time.perf_counter()
    index = build_index(kitti_np, backend="sharded", n_shards=8,
                        child_backend="trueknn", device=dev)
    log(f"  built 8 trueknn shards (sizes {index.stats()['shard_sizes']}) "
        f"in {time.perf_counter() - t0:.2f}s")

    def run(tag, fn):
        before = index.stats()["child_dispatches"]
        res, wall, counts = counted(f"sharded {tag}", fn, tally)
        log(f"  {tag}: plan={res.timings['plan']} child dispatches="
            f"{index.stats()['child_dispatches'] - before} "
            f"wall_s={wall:.4f} launches {counts}")
        return res, wall

    secs = {}
    knn_batches = []
    for b in (1, 2):
        rows = np.sort(rng.choice(N_MAIN, DIST_ROWS, replace=False))
        q = kitti_np[rows]
        res, secs[f"knn batch {b}"] = run(
            f"KnnSpec(8) batch {b} ({DIST_ROWS} rows, "
            f"seed {index.stats()['warm_seed'].get('l2')})",
            lambda: index.query(q, KnnSpec(8)))
        want = tk_index.query(q, KnnSpec(8))
        same_arrays("sharded knn vs trueknn", res, want, ("dists", "idxs"))
        log("    vs monolithic trueknn: distances and indices bitwise")
        knn_batches.append((q, res))
    rows5, csr5 = range5
    q5 = kitti_np[rows5]
    res, secs["hybrid"] = run(f"HybridSpec(8, {radius:.6g})",
                              lambda: index.query(q5, HybridSpec(8, radius)))
    want = tk_index.query(q5, HybridSpec(8, radius))
    same_arrays("sharded hybrid vs trueknn", res, want, ("dists", "idxs"))
    # a sharded answer's found is the in-ball count it returns, min(k, ball)
    # (the brute oracle's); trueknn's is the whole ball
    check(np.array_equal(res.found, np.minimum(want.found, 8)),
          "sharded hybrid vs trueknn: found differs from min(8, ball)")
    log("    vs monolithic trueknn: distances and indices bitwise, found "
        "equal to min(8, trueknn's ball count)")
    res, secs["range"] = run(f"RangeSpec({radius:.6g})",
                             lambda: index.query(q5, RangeSpec(radius)))
    same_arrays("sharded range vs phase 5", res, csr5,
                ("offsets", "idxs", "dists"))
    log(f"    vs phase 5's CSR: offsets, indices and distances bitwise; "
        f"nnz={len(res.idxs)}")
    res, secs["all_pairs"] = run("AllPairsSpec(8)",
                                 lambda: index.query(None, AllPairsSpec(8)))
    same_arrays("sharded all-pairs vs phase 4", res, b2, ("dists", "idxs"))
    log(f"    vs phase 4's batch 2: distances and indices bitwise; self-local "
        f"rows "
        f"{res.timings.get('self_local_rows')}, boundary rows "
        f"{res.timings.get('self_boundary_rows')}")
    s = index.stats()
    log(f"  pruned {s['shard_visits_pruned']} of "
        f"{s['shard_visits'] + s['shard_visits_pruned']} (query, shard) "
        f"visits (rate {s['prune_rate']}), {s['child_dispatches']} child "
        f"dispatches, {s['shard_rounds']} shared-cut rounds")
    return secs, knn_batches


# -- phases 15-16: the placed shard fabric and the mutable index ------------


def hold_slot(dev, tag, q, blk, mask, k, metric, thr):
    """One fabric slot's ``pairwise_topk`` call (the rows ``mask``
    selects, outputs pre-filled with (inf, B) and count 0, no self ids)
    against the plain version on the same tensors, bitwise; both timed.
    Returns a ``shape_row``."""
    import torch

    from repro_torch.kernels.ops import topk_engine
    from repro_torch.kernels.ref import pairwise_topk_ref

    m, n = q.shape[0], blk.shape[0]
    none = torch.full((m,), -1, dtype=torch.int32, device=dev)

    def fresh():
        return (torch.full((m, k), math.inf, device=dev),
                torch.full((m, k), n, dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.int32, device=dev))

    got, want = fresh(), fresh()
    topk_engine(q, none, blk, thr, k=k, metric=metric, row_mask=mask,
                out=got)
    pairwise_topk_ref(q, blk, k, radius2=thr, query_ids=none, metric=metric,
                      row_mask=mask, out=want)
    torch.cuda.synchronize()
    err = compare_topk(tag, got, want, q, blk, metric, True)
    sync = torch.cuda.synchronize
    ms = median_ms(lambda: topk_engine(q, none, blk, thr, k=k, metric=metric,
                                       row_mask=mask, out=fresh()), 3, sync)
    plain = median_ms(lambda: pairwise_topk_ref(
        q, blk, k, radius2=thr, query_ids=none, metric=metric, row_mask=mask,
        out=fresh()), 1, sync, warmup=False)
    active = int(mask.sum())
    d = q.shape[1]
    # the selected rows' work: each against every point of the slot, 3d
    # flops a pair (d subtractions and d multiply-adds, or d abs-adds)
    b = bound(m * d * 4 + n * d * 4 + m + active * (k * 8 + 4),
              active * n * 3 * d)
    log(f"  {tag}: Q={m} ({active} rows selected) N={n} d={d} k={k} "
        f"{metric}: kernel bitwise equal to the plain version (max|err|="
        f"{err:g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]})")
    return shape_row(f"{tag} Q={m} active={active} N={n} d={d} k={k} "
                     f"{metric}", ms, plain, b, active_rows=active), err


def phase_placed(dev, kitti_np, tk_index, knn14, range5, radius, tally):
    """Phase 15: ``backend="sharded", placement="devices"`` (8 morton
    trueknn shards of kitti 2^20 on the default mesh, one card): the fused
    kNN rounds on phase 14's two batches, the per-round path (cosine),
    hybrid and range, the L1 range's escalated dispatch; each answer held
    bitwise against phase 14's, the monolithic trueknn's, phase 5's CSR or
    brute L1.  Then a 6-shard index on four positions of the card is
    rebalanced, and one slot call of round 0, the escalation's slot call
    and an ``l2diff`` call at d = 12 are held against the plain version
    and timed."""
    import torch

    from repro_torch import (DeviceMesh, HybridSpec, KnnSpec, RangeSpec,
                             build_index)
    from repro_torch.api import get_metric
    from repro_torch.api.planner import shard_visit_mask

    t0 = time.perf_counter()
    index = build_index(kitti_np, backend="sharded", n_shards=8,
                        child_backend="trueknn", placement="devices",
                        device=dev)
    log(f"  built in {time.perf_counter() - t0:.2f}s; projected placement "
        f"{index.stats()['placement']}")
    secs = {}

    def run(tag, fn, idx=index):
        fab = idx._placed
        d0, s0 = (fab.dispatches, fab.syncs) if fab else (0, 0)
        res, wall, counts = counted(f"placed {tag}", fn, tally,
                                    need=("pairwise_topk",))
        fab = idx._placed
        rounds = f" rounds={len(res.rounds)}" if getattr(res, "rounds",
                                                         None) else ""
        log(f"  {tag}: plan={res.timings['plan']}{rounds} fabric "
            f"dispatches={fab.dispatches - d0} host syncs="
            f"{fab.syncs - s0} wall_s={wall:.4f} launches {counts}")
        secs[tag] = {"wall_s": wall, "launches": counts["pairwise_topk"],
                     "syncs": fab.syncs - s0}
        return res

    batches = []
    for b, (q, want) in enumerate(knn14, 1):
        res = run(f"KnnSpec(8) batch {b}", lambda: index.query(q, KnnSpec(8)))
        same_arrays(f"placed knn batch {b} vs phase 14", res, want,
                    ("dists", "idxs", "found"))
        log(f"    vs phase 14's host fabric: distances, indices and found "
            f"bitwise; round radii {[round(r.radius, 6) for r in res.rounds]}")
        batches.append(res)
    rows5, csr5 = range5
    q5 = kitti_np[rows5]
    res = run("cosine KnnSpec(8)",
              lambda: index.query(q5, KnnSpec(8), metric="cosine"))
    want = tk_index.query(q5, KnnSpec(8), metric="cosine")
    same_arrays("placed cosine vs trueknn", res, want, ("dists", "idxs"))
    log("    vs the monolithic trueknn's cosine (l2_view): bitwise")
    res = run(f"HybridSpec(8, {radius:.6g})",
              lambda: index.query(q5, HybridSpec(8, radius)))
    want = tk_index.query(q5, HybridSpec(8, radius))
    same_arrays("placed hybrid vs trueknn", res, want, ("dists", "idxs"))
    check(np.array_equal(res.found, np.minimum(want.found, 8)),
          "placed hybrid: found differs from min(8, ball)")
    log("    vs monolithic trueknn: distances and indices bitwise, found "
        "min(8, ball)")
    res = run(f"RangeSpec({radius:.6g})",
              lambda: index.query(q5, RangeSpec(radius)))
    same_arrays("placed range vs phase 5", res, csr5,
                ("offsets", "idxs", "dists"))
    log(f"    vs phase 5's CSR: bitwise, nnz={len(res.idxs)}")
    r_l1 = 2.0 * radius  # balls of more than 32 rows in some shard
    res = run(f"L1 RangeSpec({r_l1:.6g})",
              lambda: index.query(q5, RangeSpec(r_l1), metric="l1"))
    check(res.timings["fused_dispatches"] == 2,
          "the L1 range did not take the escalated dispatch")
    brute = build_index(kitti_np, backend="brute", device=dev)
    want = brute.query(q5, RangeSpec(r_l1), metric="l1")
    same_arrays("placed L1 range vs brute", res, want,
                ("offsets", "idxs", "dists"))
    log(f"    escalated (2 dispatches); vs brute L1: bitwise, nnz="
        f"{len(res.idxs)}, max row {int(res.counts.max())}")
    st = index.stats()
    log(f"  pruned {st['shard_visits_pruned']} of "
        f"{st['shard_visits'] + st['shard_visits_pruned']} (query, shard) "
        f"visits (rate {st['prune_rate']}); placement {st['placement']}")
    secs["prune_rate"] = st["prune_rate"]

    mesh = DeviceMesh([dev] * 4)
    six = build_index(kitti_np, backend="sharded", n_shards=6,
                      child_backend="trueknn", placement="devices",
                      device=dev, mesh=mesh)
    before = run("6 shards on 4 positions, KnnSpec(8)",
                 lambda: six.query(q5, KnnSpec(8)), six)
    occ0 = six.stats()["placement"]["device_occupancy"]
    check(six.rebalance() is True, "rebalance found no free slot")
    after = run("after rebalance, KnnSpec(8)",
                lambda: six.query(q5, KnnSpec(8)), six)
    same_arrays("rebalance", before, after, ("dists", "idxs", "found"))
    same_arrays("rebalanced vs trueknn", after,
                tk_index.query(q5, KnnSpec(8)), ("dists", "idxs"))
    occ = six.stats()["placement"]["device_occupancy"]
    check(len(occ) == 4 and min(occ) > 0 and sum(occ) == N_MAIN,
          f"occupancy after rebalance {occ}")
    log(f"  rebalance: occupancy {occ0} -> {occ}; answers bitwise before "
        f"and after, and equal to the monolithic trueknn")

    # round 0 of batch 1, the slot with the most selected rows
    fab = index._placed
    q, _ = knn14[0]
    r0 = np.float32(batches[0].rounds[0].radius)
    b32 = index._bounds(q, get_metric("l2")).astype(np.float32)
    qd = torch.as_tensor(q, device=dev)
    blocks = fab._placed_blocks("raw")
    j = max(range(fab.n_slots), key=lambda j: int((b32[:, fab.slots[j][0]]
                                                   <= r0).sum()))
    mask = torch.as_tensor(b32[:, fab.slots[j][0]] <= r0,
                           device=dev).to(torch.uint8)
    slot_row, err1 = hold_slot(dev, f"placed slot {j} round 0", qd,
                               blocks[j], mask, 8, "l2diff", math.inf)
    # the L1 range's escalated call on its fullest slot, at the path's k:
    # the next power of two of the fullest (row, shard) ball
    visit = shard_visit_mask(index._bounds(q5, get_metric("l1")), r_l1)
    j1 = max(range(fab.n_slots), key=lambda j: int(visit[:, fab.slots[j][0]]
                                                   .sum()))
    rows = np.repeat(np.arange(ROWS), np.diff(want.offsets))
    ball = np.bincount(rows * index.n_shards + index._part.assign[want.idxs],
                       minlength=ROWS * index.n_shards)
    k_esc = min(1 << (int(ball.max()) - 1).bit_length(), fab.block_rows)
    check(k_esc > 32, f"escalation k {k_esc}")
    mask1 = torch.as_tensor(visit[:, fab.slots[j1][0]],
                            device=dev).to(torch.uint8)
    esc_row, err2 = hold_slot(dev, f"range escalation slot {j1}",
                              torch.as_tensor(q5, device=dev), blocks[j1],
                              mask1, k_esc, "l1", float(r_l1))
    wide = torch.as_tensor(np.random.default_rng(13).normal(
        size=(1 << 17, 12)).astype(np.float32), device=dev)
    w_rows = torch.as_tensor(np.random.default_rng(14).choice(
        1 << 17, ROWS, replace=False), device=dev)
    d12_row, err3 = hold_slot(dev, "l2diff d=12", wide[w_rows] + 0.01, wide,
                              torch.ones(ROWS, dtype=torch.uint8,
                                         device=dev), 9, "l2diff", 20.0)
    return secs, [slot_row, esc_row, d12_row], max(err1, err2, err3), index


def phase_mutable(dev, kitti_np, range5, radius, tally):
    """Phase 16: ``backend="mutable"`` over a trueknn base of kitti 2^20:
    2^14 inserted rows of a second kitti draw (8 sealed 2048-row brute
    deltas), 64 deletes (32 base ids, 32 inserted); ``KnnSpec(8)``,
    ``HybridSpec(8, r)`` and ``RangeSpec(r)`` on phase 5's rows held
    against a trueknn index rebuilt over the live rows (``map_to_stable``),
    again after ``compact()``, and one background compaction."""
    import threading

    from repro_torch import (HybridSpec, KnnSpec, RangeSpec, build_index,
                             make_dataset, make_mutable, map_to_stable)

    q5 = kitti_np[range5[0]]
    secs = {}
    mut = build_index(kitti_np, backend="mutable", base_backend="trueknn",
                      delta_rows=2048, auto_compact="off", device=dev)
    extra = make_dataset("kitti", 1 << 14, seed=1)
    t0 = time.perf_counter()
    ids = np.concatenate([mut.insert(extra[i:i + 2048])
                          for i in range(0, 1 << 14, 2048)])
    secs["inserts"] = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    dead = np.concatenate([rng.choice(N_MAIN, 32, replace=False),
                           rng.choice(ids, 32, replace=False)])
    check(mut.delete(dead) == 64, "64 deletes")
    st = mut.stats()
    check(st["delta_shards"] == 8 and st["tombstones"] == 64,
          f"mutable state {st}")
    log(f"  {len(ids)} rows inserted in {secs['inserts']:.4f}s (8 sealed "
        f"2048-row brute deltas), 64 ids deleted; n_points={mut.n_points} "
        f"sentinel={mut.sentinel}")
    specs = [("KnnSpec(8)", KnnSpec(8)),
             (f"HybridSpec(8, {radius:.6g})", HybridSpec(8, radius)),
             (f"RangeSpec({radius:.6g})", RangeSpec(radius))]

    def run(tag, spec, need, idx=mut):
        res, wall, counts = counted(f"mutable {tag}",
                                    lambda: idx.query(q5, spec), tally,
                                    need=need)
        log(f"  {tag}: plan={res.timings['plan']} wall_s={wall:.4f} "
            f"launches {counts}")
        secs[tag] = wall
        return res

    got = {tag: run(tag, spec, ("grid_round", "pairwise_topk"))
           for tag, spec in specs}
    live_pts, live_ids = mut.snapshot()
    t0 = time.perf_counter()
    rebuild = build_index(live_pts, backend="trueknn", device=dev)
    want = {tag: map_to_stable(rebuild.query(q5, spec), live_ids,
                               mut.sentinel) for tag, spec in specs}
    log(f"  trueknn rebuilt over the {len(live_ids)} live rows and queried "
        f"in {time.perf_counter() - t0:.2f}s")

    def hold(stage, res_of, exact):
        for tag, spec in specs:
            a, b = res_of[tag], want[tag]
            if isinstance(spec, RangeSpec):
                moved = same_csr_up_to_ties(f"{stage} {tag}", a, b)
            else:
                moved = knn_up_to_ties(f"{stage} {tag}", a.dists, a.idxs,
                                       b.dists, b.idxs)
            if isinstance(spec, HybridSpec):
                check(np.array_equal(a.found, np.minimum(b.found, 8)),
                      f"{stage} {tag}: found is not min(8, live ball)")
            check(not exact or moved == 0,
                  f"{stage} {tag}: {moved} rows list ties in another order")
            log(f"    {stage} {tag} vs the rebuild: distances bitwise, "
                f"indices bitwise {'' if moved == 0 else 'up to tie order '}"
                f"({moved} rows list tied neighbors in another order)")

    hold("with deltas", got, exact=False)
    t0 = time.perf_counter()
    check(mut.compact(), "compact() refused")
    secs["compact"] = time.perf_counter() - t0
    st = mut.stats()
    check(st["delta_shards"] == 0 and st["tombstones"] == 0
          and st["base_rows"] == len(live_ids), f"after compact {st}")
    log(f"  compact() in {secs['compact']:.4f}s: base_rows="
        f"{st['base_rows']}, generation {st['generation']}")
    got = {tag: run(f"{tag} after compact", spec, ("grid_round",))
           for tag, spec in specs}
    hold("compacted", got, exact=True)

    # background: the second 2048-row insert makes a compaction due; the
    # rebuild is parked before its swap while the pre-swap snapshot (the
    # base and two deltas) answers, then released and joined
    bg = make_mutable(rebuild, delta_rows=2048, compact_min_rows=4096,
                      compact_ratio=0.001, auto_compact="background")
    built, release = threading.Event(), threading.Event()

    def parked(_index):
        built.set()
        release.wait(timeout=300)

    bg._on_compact_built = parked
    for i in range(0, 4096, 2048):
        bg.insert(extra[i:i + 2048] + np.float32(0.001))
    check(built.wait(timeout=300), "the background compaction never ran")
    before = bg.query(q5, KnnSpec(8))
    t0 = time.perf_counter()
    release.set()
    bg._bg.join(timeout=300)
    secs["background_swap"] = time.perf_counter() - t0
    after = bg.query(q5, KnnSpec(8))
    st = bg.stats()
    check(st["compactions"] == 1 and st["delta_shards"] == 0,
          f"background compaction {st}")
    moved = knn_up_to_ties("background compaction", after.dists, after.idxs,
                           before.dists, before.idxs)
    log(f"  background compaction of 4096 inserted rows: answers before the "
        f"swap (base + 2 deltas) and after (one base) equal: distances "
        f"bitwise, {moved} rows list tied neighbors in another order")
    return secs, mut


# -- phases 17-18: the serving layer, the applications and the launcher -----


SERVE_BATCH = 1024  # phase 17's max_batch: rows coalesced into one batch
SERVE_RATE = 20000.0  # phase 17 (a): offered single-row requests per second
LM_N = 1 << 20  # phase 18: kNN-LM datastore rows
LM_D = 1024  # Khandelwal et al.'s key width
LM_VOCAB = 32768
LAUNCH_SMALL_N = 1 << 16  # phase 18: the launcher's graph and DBSCAN runs


class HostReads:
    """Counts device-to-host reads while active: ``.cpu()``, ``.item()``,
    ``.tolist()`` and truth / int / float conversions of card tensors, and
    ``torch.cuda.synchronize`` calls, from any thread."""

    NAMES = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__")

    def __enter__(self):
        import torch

        self.n = 0
        self._saved = {name: torch.Tensor.__dict__.get(name)
                       for name in self.NAMES}
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrap(t, *a, _orig=orig, **kw):
                if t.is_cuda:
                    self.n += 1
                return _orig(t, *a, **kw)

            setattr(torch.Tensor, name, wrap)
        self._sync = torch.cuda.synchronize

        def sync(*a, **kw):
            self.n += 1
            return self._sync(*a, **kw)

        torch.cuda.synchronize = sync
        return self

    def __exit__(self, *exc):
        import torch

        for name, orig in self._saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)
        torch.cuda.synchronize = self._sync
        return False


def same_rows(tag, results, direct):
    """Tickets of consecutive row blocks against one direct query of all
    the rows: kNN distances, indices and found (where the direct answer
    has it), or the range CSR's counts, indices and distances, bitwise."""
    if hasattr(direct, "offsets"):
        counts = np.concatenate([r.counts for r in results])
        check(np.array_equal(counts, direct.counts), f"{tag}: range counts")
        for key in ("idxs", "dists"):
            got = np.concatenate([getattr(r, key) for r in results])
            check(np.array_equal(got, getattr(direct, key)),
                  f"{tag}: range {key}")
        return
    for key in ("dists", "idxs"):
        got = np.vstack([getattr(r, key) for r in results])
        check(np.array_equal(got, getattr(direct, key)), f"{tag}: {key}")
    if direct.found is not None:
        got = np.concatenate([r.found for r in results])
        check(np.array_equal(got, direct.found), f"{tag}: found")


def bucket_line(name, b, extra=""):
    return (f"    bucket {name}: {b['requests']} requests, {b['rows']} rows "
            f"in {b['batches']} batches, hist {b['batch_size_hist']}, p50 "
            f"{b['latency_p50_ms']} ms, p99 {b['latency_p99_ms']} ms{extra}")


def phase_server(dev, kitti_np, lidar, placed, mut, range5, radius, graph11,
                 tally):
    """Phase 17: ``NeighborServer`` in worker-thread mode on the card over
    three tenants reused from earlier phases (phase 4's warm trueknn index
    ``lidar``, phase 15's placed 8-shard index, phase 16's compacted
    mutable index): (a) a Poisson open loop of single-row ``KnnSpec(8)``
    requests on ``lidar``; (b) multi-row kNN, hybrid and range requests
    on every tenant; (c) inserts and deletes on ``mutable`` between reads;
    (d) a kNN-graph ticket on ``lidar``.  Every ticket is held against a
    direct ``index.query`` of the same rows (and the graph against phase
    11's) bitwise, and the server's counters must reconcile."""
    from repro_torch import (HybridSpec, KnnSpec, NeighborServer, RangeSpec,
                             make_dataset)
    from repro_torch.api.server import poisson_open_loop

    q5 = kitti_np[range5[0]]
    out = {}

    def fabric_syncs():  # host syncs of the placed tenant's fabric
        fab = placed._placed
        return 0 if fab is None else fab.syncs

    def drive(tag, fn, need):
        s0 = fabric_syncs()
        reads = HostReads()

        def run():
            with reads:
                return fn()

        res, wall, counts = counted(f"server {tag}", run, tally, need=need)
        out[tag] = {"wall_s": wall, "launches": counts,
                    "host_reads": reads.n,
                    "fabric_syncs": fabric_syncs() - s0}
        return res, wall, counts, reads.n

    # (a) the open loop on its own server, so its bucket is its own
    solo = NeighborServer(indexes={"lidar": lidar}, max_batch=SERVE_BATCH,
                          cache_size=0)
    (results, wall_a, lat), wall, counts, reads = drive(
        "open loop", lambda: poisson_open_loop(
            solo, q5, KnnSpec(8), SERVE_RATE, np.random.default_rng(17),
            index="lidar", timeout=600.0),
        ("grid_round",))
    check(len(results) == ROWS, f"open loop served {len(results)} of {ROWS}")
    direct = lidar.query(q5, KnnSpec(8))
    same_rows("open loop vs direct", results, direct)
    st = solo.stats()
    b = st["buckets"]["lidar/knn/k=8/l2"]
    check(st["submitted"] == st["served"] == ROWS and st["rejected"] == 0,
          f"open loop stats {st['submitted']} {st['served']}")
    check(b["requests"] == ROWS and b["rows"] == ROWS, "open loop bucket")
    check(max(b["batch_size_hist"]) > 1, "open loop never coalesced")
    out["open loop"].update(requests_per_s=ROWS / wall_a,
                            p50_ms=b["latency_p50_ms"],
                            p99_ms=b["latency_p99_ms"],
                            hist=b["batch_size_hist"])
    log(f"  (a) {ROWS} single-row KnnSpec(8) requests on 'lidar' offered at "
        f"{SERVE_RATE:.0f}/s: served {ROWS} in {wall_a:.4f}s "
        f"({ROWS / wall_a:.1f} requests/s), each ticket bitwise equal to a "
        f"direct query of its row (distances, indices); launches {counts}, "
        f"host reads {reads}")
    log(bucket_line("lidar/knn/k=8/l2", b))

    # (b)-(d) the three tenants on one server
    tenants = {"lidar": lidar, "placed": placed, "mutable": mut}
    server = NeighborServer(indexes=tenants, max_batch=SERVE_BATCH,
                            cache_size=0)
    specs = (("knn", KnnSpec(8)), ("hybrid", HybridSpec(8, radius)),
             ("range", RangeSpec(radius)))
    rows_b = q5[:SERVE_BATCH]
    n_req = 8
    blocks = np.split(rows_b, n_req)
    server.start()
    try:
        for name, index in tenants.items():
            for kind, spec in specs:
                need = (("pairwise_topk",) if name == "placed"
                        else ("grid_round",))
                tickets, wall, counts, reads = drive(
                    f"{name} {kind}",
                    lambda: [t.result(timeout=600) for t in [
                        server.submit(blk, spec, index=name)
                        for blk in blocks]], need)
                server.stop()  # idle: the direct query owns the index
                same_rows(f"{name} {kind}", tickets,
                          index.query(rows_b, spec))
                server.start()
                out[f"{name} {kind}"]["requests_per_s"] = n_req / wall
                log(f"  (b) '{name}' {kind}: {n_req} requests of "
                    f"{len(blocks[0])} rows in {wall:.4f}s "
                    f"({n_req / wall:.2f} requests/s), bitwise equal to a "
                    f"direct query ({'the CSR' if kind == 'range' else 'found too'}"
                    f"); launches {counts}, host "
                    f"reads {reads}, fabric syncs "
                    f"{out[f'{name} {kind}']['fabric_syncs']}")

        # (c) writes between reads on the mutable tenant
        extra = make_dataset("kitti", 2048, seed=2)
        new_q = extra[:256]

        def write_then_read():
            ins = server.submit_insert(extra, index="mutable")
            reads = server.submit(new_q, KnnSpec(8), index="mutable")
            return ins.result(timeout=600), reads.result(timeout=600)

        (minted, seen), wall, counts, reads = drive(
            "insert then read", write_then_read, ("grid_round",))
        check(len(minted) == 2048, "minted ids")
        check(bool((seen.idxs == minted[:256, None]).any(1).all()),
              "a read after the insert does not see the inserted rows")
        server.stop()
        same_rows("read after insert", [seen], mut.query(new_q, KnnSpec(8)))
        live = mut.snapshot()[1]  # phase 16 deleted some base ids
        dead = np.concatenate([minted[:64], live[live < N_MAIN][:64]])
        server.start()

        def delete_then_read():
            dl = server.submit_delete(dead, index="mutable")
            reads = server.submit(new_q, KnnSpec(8), index="mutable")
            return dl.result(timeout=600), reads.result(timeout=600)

        (n_dead, seen2), wall2, counts2, reads2 = drive(
            "delete then read", delete_then_read, ("grid_round",))
        check(n_dead == len(dead), "deleted rows")
        check(not np.isin(seen2.idxs, dead).any(),
              "a read after the delete sees deleted rows")
        server.stop()
        same_rows("read after delete", [seen2],
                  mut.query(new_q, KnnSpec(8)))
        server.start()
        log(f"  (c) 'mutable': insert 2048 rows, then KnnSpec(8) on 256 of "
            f"them: every row finds its own new id, equal to a direct query "
            f"bitwise ({wall:.4f}s, launches {counts}, host reads {reads}); "
            f"delete 128 ids, then the same read: no deleted id, equal to a "
            f"direct query ({wall2:.4f}s, launches {counts2}, host reads "
            f"{reads2})")

        # (d) a kNN-graph ticket on the warm tenant
        graph, wall, counts, reads = drive(
            "graph", lambda: server.submit_graph(8, index="lidar").result(
                timeout=600), ("grid_round",))
        for key in ("indptr", "indices", "dists"):
            check(np.array_equal(getattr(graph, key), getattr(graph11, key)),
                  f"graph ticket {key} vs phase 11")
        log(f"  (d) submit_graph(8) on 'lidar': {graph.n} nodes, "
            f"{graph.n_edges} edges, bitwise equal to phase 11's "
            f"build_knn_graph; {wall:.4f}s, launches {counts}, host reads "
            f"{reads}")
    finally:
        server.stop()
    st = server.stats()
    n_req_all = 3 * 3 * n_req + 4 + 1  # reads, two writes and two reads, graph
    check(st["submitted"] == st["served"] == n_req_all, "server requests")
    check(st["rejected"] == 0 and st["pending_rows"] == 0,
          "server rejected or pending")
    rows_all = sum(b["rows"] for b in st["buckets"].values())
    check(rows_all == 9 * SERVE_BATCH + 2048 + 256 + 128 + 256 + 1,
          f"server rows {rows_all}")
    for name, b in st["buckets"].items():
        if "/write/" not in name and "/graph/" not in name:
            check(max(b["batch_size_hist"]) > len(blocks[0]),
                  f"{name} never coalesced")
        log(bucket_line(name, b))
    check(st["placement"]["tenants"]["placed"]["fused_dispatches"] > 0,
          "placement roll-up")
    log(f"  stats reconcile: {st['submitted']} requests submitted and "
        f"served, 0 rejected, {rows_all} rows; writes {st['writes']}; "
        f"workloads {st['workloads']}; placement fused dispatches "
        f"{st['placement']['fused_dispatches']}")
    return out


def phase_apps(dev, kitti_np, b2, tally):
    """Phase 18: the oracle radii on kitti 2^20 against phase 4's batch 2,
    a kNN-LM datastore of 2^20 synthetic hidden states of width 1024 with
    ``knn_logprobs`` on 4096 rows, and the serving launcher's modes in
    process."""
    import contextlib
    import io

    import torch

    from repro_torch import KnnSpec
    from repro_torch.core import max_knn_distance, percentile_knn_distance
    from repro_torch.core.knnlm import build_datastore, knn_logprobs
    from repro_torch.launch import serve

    out = {}
    kitti = torch.as_tensor(kitti_np, device=dev)
    kth = b2.dists[:, 7]
    for name, fn, want in (
            ("max_knn_distance", lambda: max_knn_distance(kitti, 8),
             float(np.max(kth))),
            ("percentile_knn_distance",
             lambda: percentile_knn_distance(kitti, 8, 99.0),
             float(np.percentile(kth, 99.0)))):
        got, wall, counts = counted(name, fn, tally, need=("pairwise_topk",))
        check(got == want, f"{name} {got} != phase 4's {want}")
        out[name] = wall
        log(f"  {name}(kitti 2^20, 8) = {got!r}, equal to phase 4's batch 2 "
            f"8th column; wall_s={wall:.4f} launches {counts}")
    del kitti

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    hid = rng.standard_normal((LM_N, LM_D), dtype=np.float32)
    tgt = rng.integers(0, LM_VOCAB, LM_N)
    q_hid = rng.standard_normal((ROWS, LM_D), dtype=np.float32)
    gen_s = time.perf_counter() - t0
    store, build_s, counts = counted(
        "kNN-LM build", lambda: build_datastore(hid, tgt, device=dev), tally,
        need=())
    del hid
    check(store.keys3d.shape == (LM_N, 3) and np.isfinite(store.keys3d).all(),
          "datastore keys")
    seen = []
    query = store.index.query

    def keep(*a, **kw):
        res = query(*a, **kw)
        seen.append(res)
        return res

    store.index.query = keep
    try:
        probs, wall, counts = counted(
            "knn_logprobs",
            lambda: knn_logprobs(store, q_hid, LM_VOCAB, k=8), tally)
    finally:
        del store.index.query
    check(probs.shape == (ROWS, LM_VOCAB) and np.isfinite(probs).all(),
          "kNN-LM distribution shape")
    sums = probs.sum(1, dtype=np.float64)
    check(np.abs(sums - 1.0).max() <= 1e-5, "kNN-LM rows sum to 1")
    retrieval = seen[0]
    direct = store.index.query(store.projector(q_hid), KnnSpec(8))
    check(np.array_equal(retrieval.dists, direct.dists)
          and np.array_equal(retrieval.idxs, direct.idxs),
          "kNN-LM retrieval vs a direct query")
    # the reference's host formula on the same retrieval
    w = np.exp(-retrieval.dists / np.float32(1.0))
    w = np.where(np.isfinite(retrieval.dists), w, 0.0)
    w = w / np.clip(w.sum(1, keepdims=True), 1e-12, None)
    want = np.zeros((ROWS, LM_VOCAB), np.float32)
    t_ids = store.targets[np.clip(retrieval.idxs, 0, LM_N - 1)]
    for i in range(ROWS):
        np.add.at(want[i], t_ids[i], w[i])
    err = float(np.abs(probs - want).max())
    check(err <= 1e-6, f"kNN-LM distribution vs the host formula {err}")
    out.update(lm_generate_s=gen_s, lm_build_s=build_s, knn_logprobs_s=wall)
    log(f"  kNN-LM: {LM_N} hidden states of width {LM_D} drawn in "
        f"{gen_s:.2f}s, PCA to 3-D and a trueknn index on the card in "
        f"{build_s:.2f}s; knn_logprobs on {ROWS} rows, vocab {LM_VOCAB}: "
        f"{wall:.4f}s, launches {counts}; retrieval bitwise equal to a "
        f"direct query, rows sum to 1 within "
        f"{np.abs(sums - 1.0).max():.2e}, max |err| {err:.2e} against the "
        f"reference's host formula; start "
        f"{retrieval.timings.get('start_radius_source')}, rounds "
        f"{retrieval.n_rounds}")
    del store, probs, want

    runs = (
        ("knn open loop", ["--mode", "knn", "--n", str(N_MAIN), "--arrival",
                           "open", "--rate", f"{SERVE_RATE:.0f}",
                           "--batches", "1", "--batch-size",
                           str(2 * SERVE_BATCH)], ("grid_round",)),
        ("knn placed", ["--mode", "knn", "--n", str(N_MAIN), "--backend",
                        "sharded", "--placement", "devices", "--devices",
                        "4", "--arrival", "closed", "--batches", "2",
                        "--batch-size", str(SERVE_BATCH)],
         ("pairwise_topk",)),
        ("graph", ["--mode", "graph", "--n", str(LAUNCH_SMALL_N), "--k",
                   "8"], ("grid_round",)),
        ("dbscan", ["--mode", "dbscan", "--n", str(LAUNCH_SMALL_N),
                    "--min-pts", "8"], ("grid_round",)),
    )
    for tag, argv, need in runs:
        argv = argv + ["--device", str(dev)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, wall, counts = counted(f"launcher {tag}",
                                      lambda: serve.main(argv), tally,
                                      need=need)
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"    | {line}")
        log(f"  launcher {' '.join(argv)}: wall_s={wall:.4f} launches "
            f"{counts}")
        out[f"launcher {tag}"] = wall
        if tag == "knn open loop":
            n = 2 * SERVE_BATCH
            check(f"open loop: {n}/{n} requests served" in text,
                  "launcher open loop")
        elif tag == "knn placed":
            check("mesh: 4 positions" in text and "/placed=" in text
                  and "placement 'default': 8 slots on 4 devices" in text,
                  "launcher placed")
        elif tag == "graph":
            check(f"{LAUNCH_SMALL_N} nodes" in text, "launcher graph")
        else:
            check("clusters" in text and f"noise of {LAUNCH_SMALL_N}" in text,
                  "launcher dbscan")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch import make_dataset
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; {smi}")
    t0 = time.perf_counter()
    ext = build.extension()
    log(f"  built {ext.__name__} ({', '.join(build.SOURCES)}) in "
        f"{time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(SEED)
    kitti_np = make_dataset("kitti", N_MAIN)
    kitti = torch.as_tensor(kitti_np, device=dev)
    porto = torch.as_tensor(make_dataset("porto", N_PORTO), device=dev)

    log("phase 2: pairwise_topk kernel vs plain version")
    pw_err = phase_pairwise(dev, kitti, porto, rng)
    log("phase 3: grid_round kernel vs plain version")
    kitti_sched, grid_err, heavy = phase_grid(dev, kitti_np, rng)
    log(f"  (schedule of {len(kitti_sched[0].radii)} rounds)")
    log("phase 4: main path, trueknn KnnSpec(8) self-query on kitti 2^20")
    index, (b1, b2), main_counts, radius = phase_main(dev, kitti_np, rng)
    log("phase 5: brute RangeSpec at full width")
    range_counts, q, qid, thr, range_err, range5 = phase_range(
        dev, kitti_np, radius, rng)
    log("phase 6: porto 2^18, fused and host loop")
    phase_porto(dev, rng)
    log("phase 7: kernel times at main-path shapes")
    pw_t, samp_t, g_t, heavy_t = phase_times(dev, index, b1, q, qid, thr,
                                             heavy, rng)
    log("phase 8: grid_round's two designs on every scheduled grid")
    sweep = phase_designs(dev, kitti_sched)
    del kitti_sched
    tally = {"pairwise_topk": 0, "grid_round": 0}
    log(f"phase 9: fixed_radius on kitti 2^20 at r = {radius:.6g}")
    fr_index = phase_fixed_radius(dev, kitti_np, radius, range5, rng, tally)
    log("phase 10: generic routes on 4096 rows")
    route_s = phase_routes(dev, kitti_np, index, fr_index, rng, tally)
    log("phase 11: all-pairs self-queries, kNN graph and DBSCAN")
    range_rounds, graph11 = phase_all_pairs(dev, index, fr_index, b2, radius,
                                            tally)
    log(f"  phases 9-11 launches {tally}; route seconds "
        f"{json.dumps(route_s)}")
    del fr_index
    t0 = time.perf_counter()
    log("phase 12: distributed dense, 4 positions on one card, kitti 2^22")
    mesh = phase_distributed(dev, rng, tally)
    log(f"  phase 12 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    log("phase 13: distributed_trueknn_grid on phase 12's mesh, uniform "
        "2^22")
    phase_distributed_grid(dev, mesh, rng, tally)
    log(f"  phase 13 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    log("phase 14: sharded (placement='host') over kitti 2^20, 8 trueknn "
        "shards")
    sharded_s, knn14 = phase_sharded(dev, kitti_np, index, b2, range5,
                                     radius, rng, tally)
    log(f"  phase 14 took {time.perf_counter() - t0:.1f}s; seconds "
        f"{json.dumps(sharded_s)}")
    t0 = time.perf_counter()
    log("phase 15: sharded (placement='devices') over kitti 2^20, 8 trueknn "
        "shards on one card")
    placed_s, placed_rows, placed_err, placed = phase_placed(
        dev, kitti_np, index, knn14, range5, radius, tally)
    log(f"  phase 15 took {time.perf_counter() - t0:.1f}s; per batch "
        f"{json.dumps(placed_s)}")
    t0 = time.perf_counter()
    log("phase 16: mutable over a trueknn base of kitti 2^20")
    mutable_s, mut = phase_mutable(dev, kitti_np, range5, radius, tally)
    log(f"  phase 16 took {time.perf_counter() - t0:.1f}s; seconds "
        f"{json.dumps(mutable_s)}")
    t0 = time.perf_counter()
    log("phase 17: NeighborServer on the card, worker thread, tenants "
        "'lidar' (phase 4), 'placed' (phase 15), 'mutable' (phase 16)")
    server_s = phase_server(dev, kitti_np, index, placed, mut, range5,
                            radius, graph11, tally)
    del placed, mut, graph11
    log(f"  phase 17 took {time.perf_counter() - t0:.1f}s; per part "
        f"{json.dumps(server_s)}")
    t0 = time.perf_counter()
    log("phase 18: oracle radii, kNN-LM datastore and the serving launcher")
    apps_s = phase_apps(dev, kitti_np, b2, tally)
    log(f"  phase 18 took {time.perf_counter() - t0:.1f}s; seconds "
        f"{json.dumps(apps_s)}")
    log(f"  phases 9-18 launches {tally}")
    t_k, t_p, pw_b, _ = pw_t
    g_k, g_p, g_b = g_t
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; total {time.perf_counter() - t_start:.1f}s")

    kernels = [
        {
            "name": "pairwise_topk",
            "route": "cuda",
            "source": "src/repro_torch/csrc/pairwise_topk.cu",
            "replaces": "src/repro/kernels/pairwise_topk.py:181",
            "launches": main_counts["pairwise_topk"]
            + range_counts["pairwise_topk"] + tally["pairwise_topk"],
            "max_abs_err": max(pw_err, range_err, placed_err),
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": pw_b[0],
            "bound_by": pw_b[1],
            "library_ms": None,
            "held_in": ["phase 2", "phase 5", "phase 9", "phase 10",
                        "phase 11", "phase 12", "phase 15", "phase 17",
                        "phase 18"],
            "shapes": [
                shape_row(tag, *t[:3], splits=t[3][0], first_pass_ms=t[3][1],
                          merge_ms=t[3][2])
                for tag, t in (("Q=4096 N=2^20 d=3 k=32 range", pw_t),
                               ("Q=100 N=2^20 d=3 k=5 sampler", samp_t))
            ] + placed_rows,
        },
        {
            "name": "grid_round",
            "route": "cuda",
            "source": "src/repro_torch/csrc/grid_round.cu",
            "replaces": "src/repro/core/fixed_radius.py:36",
            "launches": main_counts["grid_round"]
            + range_counts["grid_round"] + tally["grid_round"],
            "max_abs_err": grid_err,
            "ms": g_k,
            "plain_ms": g_p,
            "bound_ms": g_b[0],
            "bound_by": g_b[1],
            "library_ms": None,
            "held_in": ["phase 3", "phase 7", "phase 8", "phase 9",
                        "phase 10", "phase 11", "phase 13", "phase 14",
                        "phase 16", "phase 17", "phase 18"],
            "design_sweep": sweep,
            "shapes": [
                shape_row("round 0 of batch 1 Q=2^20 k=8", g_k, g_p, g_b),
                shape_row(f"heaviest round t={heavy[2]} Q=2^20 k=8 "
                          f"res={heavy[0].res} cap={heavy[0].cap}",
                          *heavy_t[:3], n_tests=heavy_t[3]),
            ] + [
                shape_row(f"counted range round Q=2^20 k={k}", ms, None, b,
                          n_tests=nt)
                for k, ms, b, nt in range_rounds
            ],
        },
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
