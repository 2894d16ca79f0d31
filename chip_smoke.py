#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds both CUDA kernels from ``src/repro_torch/csrc`` (one
``torch.utils.cpp_extension.load`` call), holds each against its plain
PyTorch version on the card, then drives the port's entry points (the
trueknn, brute, fixed_radius, distributed, sharded and mutable backends,
the planner's generic routes, all-pairs self-queries, the graph
workloads, the server, the kNN-LM datastore, the launcher, the LM stack
and its training) at full width through the user API and checks what
comes out:

1. device and build;
2. ``pairwise_topk`` kernel vs plain version: L2 at d = 2, 3, 16, L1, L∞,
   cosine, self ids, finite radii, k in {1, 5, 8, 32, 64, 300}, on
   main-path shapes (N = 2^20), the split-N path (S > 1 ranges and the
   merge) checked taken where it must be: the sampler's Q = 100, k = 300,
   and exact duplicate points on both sides of every range boundary of the
   kernel's own split; the ``l2diff`` form at d = 12; every list size past
   k = 32 (k in ``WIDE_KS``: the register lists of 64 to 1024 entries and
   the row list above) in L2, L1 and L∞ at d = 3 and L2 at d = 16,
   duplicates that tie inside a 32-point chunk, across chunks and across
   the split's bounds, and single-row and eight-row calls at k = 256 over
   hundreds of ranges; then a ``row_mask`` that is all zero and one that
   keeps every third row, at k = 32 and 128 (the other rows must stay
   untouched).  Counts exact; values bitwise where both take the
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
   ``unres``, ``res_round`` and ``executed`` bitwise; then the fused
   loop's few-row rounds on that grid (every row of the cloud in the call,
   1 and 206 of them unresolved), where the kernel splits each active tile
   S ways across the card and merges: every output and flag bitwise
   against the plain version, T = 1 and S > 1 as the launch reports them,
   timed (the split pass and the merge apart, from a profiler trace)
   beside its bound;
4. main path: ``build_index(kitti 2^20, backend="trueknn")`` and two
   self-query ``KnnSpec(8)`` batches (sampled, then warm), with 4096 rows
   checked against the brute backend;
5. brute ``RangeSpec`` at full width on 4096 rows, CSR vs the plain
   version's;
6. the heavy-tailed 2-D cloud (porto 2^18): fused self-query with its
   rounds' grids, and a 4096-row query whose fused and host-loop answers
   and round stats must be equal;
7. kernel times against their bounds at every timed shape: ``pairwise_topk``
   at Q = 4096, k = 32 and at the sampler's Q = 100, k = 5, Q = 4096
   self-queries at k = 64, 128, 256, 1024, single-row and eight-row calls
   at k = 256 and Q = 512 at k = 300 (each also as first pass and merge
   apart, each pass with its bound); ``grid_round`` on round 0 of batch 1 and
   one non-fused launch on the heaviest scheduled grid at full width,
   whose n_tests must be exactly N * N when the grid has res <= 2 per axis;
8. ``grid_round``'s two designs timed on every scheduled grid of kitti,
   porto, road and uniform (the fused loop's rounds, and every row on
   the grids between fine and collapsed), held bitwise equal to each
   other, against the design the wrapper picks; each round's active rows,
   and the tiles T and splits S the launch reports (``plan``), printed (S =
   1 on a coarse round over all 2^20 rows, S > 1 on one of at most 256
   rows, both checked), and every split round held
   bitwise against the same round at S = 1 and, on at most 1024 rows,
   against the plain version;
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
   counted range's rounds timed at full width (k = 32, its second round's
   k and 1024; past 32 both designs, the coarse and the fine, equal
   bitwise to each other and, on 64 rows, to the plain version),
   ``build_knn_graph`` and
   ``dbscan`` (the union-find's host seconds apart from the device part);
12. ``build_index(kitti 2^22, backend="distributed")`` on a ``DeviceMesh``
   whose model axis holds the one card at 4 positions (2^20 points a
   shard, ``configs/trueknn.py``'s widths), two ``KnnSpec(8)`` batches of
   2^16 rows, equal bitwise to the brute backend and to a one-position
   mesh; round 0's kernel call at the last position (S = 1, shifted self
   ids) held bitwise against the plain version;
13. ``distributed_trueknn_grid`` on phase 12's mesh over uniform 2^21 (on
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
16. ``backend="mutable"`` over a trueknn base of kitti 2^19 (a draw of its
   own; 2^20 before its host grid builds were cut): 2^14 rows of a
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
   column); a kNN-LM datastore of 2^18 synthetic hidden states of width
   1024 (cut from 2^20: the host draw and PCA), ``knn_logprobs`` on 4096
   rows, vocab 32,768: its retrieval
   bitwise equal to a direct query, rows summing to 1 within 1e-5, within
   1e-6 of the reference's host formula; then
   ``repro_torch.launch.serve.main`` in process: ``--mode knn`` on kitti
   2^19 (open loop; cut from 2^20, its batch 1's host grid builds), the
   placed sharded index on a 4-position mesh,
   ``--mode graph`` and ``--mode dbscan`` on 2^16 points;
19. the LM stack (``repro_torch.models``, ``serve``), eager PyTorch in
   bf16 with float32 accumulation: (a) Qwen3-0.6B at full width and
   depth from a seeded generator on the card, ``param_count()`` equal to
   the parameters built; a float32 copy's prefill (2 x 128 tokens, TF32
   off) against the CPU's float32 run; bf16 ``decode_step`` (16 teacher-
   forced steps) against ``forward``; ``BatchedServer`` serving 32
   requests (cut from 64: its decode step is host-bound) of 16-256 tokens
   through 8 slots, 64 new tokens greedy, each
   completion equal to a direct prefill + ``decode_step`` loop over the
   same padded batch (tokens/s, prefill and decode-step p50/p99, peak
   memory); (c) a kNN-LM datastore of its final hidden states over 2^18
   tokens of ``SyntheticLMStream``, ``knn_logprobs`` on 4096 rows of fresh
   tokens at the padded vocab: retrieval bitwise equal to a direct query,
   rows summing to 1 within 1e-5, both kernels launched; (b) the other
   nine architectures at full width, depth cut to one period plus the
   leading dense layers (printed as ``reduced``; SmolLM-135M whole), MoE
   capacity dropless: a prefill of 2 prompts (longer than the window for
   gemma3-27b and recurrentgemma-9b, so the ring wraps; 256 prefix
   embeddings for musicgen-medium and internvl2-26b) and 16 decode steps
   against ``forward``, in bf16 and in a float32 copy (wall time and peak
   memory printed);
20. training (``repro_torch.optim``, ``train``, the examples): (a)
   Qwen3-0.6B at full width and depth, bf16 params and f32 moments,
   ``Trainer`` over ``SyntheticLMStream`` at batch 8 x 1024 (two loss
   chunks) for 30 steps: every loss finite, no bad step, the mean of the
   last 5 losses below the first 5's (step ms p50/p99, tokens/s, peak
   memory, and one step's ``torch.profiler`` trace); (b) its float32
   copy's ``loss_fn`` gradients on 2 x 128 tokens, card (TF32 off)
   against the CPU, each leaf to a stated share of its largest, and one
   ``adamw_update`` of the same gradients on both; (c) the nine other
   architectures at ``launch.train``'s ``small`` preset: 3 float32 trainer
   steps on the card against the same on the CPU, then one bf16 step;
   (d) SmolLM-135M whole in bf16: a checkpoint at step 4 (to a
   temporary directory, removed after), a fresh ``Trainer`` restored from
   it (parameters and moments bitwise equal to those saved) replaying
   steps 4-5 against the uninterrupted run; (e)
   ``repro_torch.examples.knnlm_serve.main(["--device", "cuda"])``: both
   kernels launched, kNN-LM at lambda 0.25 below the LM-only perplexity,
   its retrieval bitwise equal to a direct query;
21. parallelism and the dry-run (``repro_torch.parallel``,
   ``launch.dryrun``): (a) Qwen3-0.6B at full width and depth (bf16
   params, f32 moments) through ``make_sharded_train_step`` on a (2, 2)
   ("data", "model") mesh of the card, 5 steps at 8 x 1024: its first
   loss against the one-device step's, the collective log equal to
   ``step_collectives``, shard GiB, step p50 and peak memory; its float32
   copy on 2 x 128, one step from the same state sharded and on one
   device (loss rtol 1e-5, parameters rtol 1e-5 above 0.01 lr); (b) its
   28 layers as a 4-stage pipeline of 7 over 4 microbatches of the
   batch's embeddings, bitwise equal to the layers in order (ticks,
   bubbles, ms); (c)
   ``compressed_psum_mean`` over 4 data positions on 4 rows' gradients,
   bitwise equal to the CPU's, its error against the exact mean; (d) the
   dry-run's trueknn cell (2^20 uniform points a shard, 2^16 queries;
   2^18 a shard for the grid engine, whose host probes bound the phase),
   dense and grid, on 256 and 512 positions of the card, 4096 rows
   against the brute backend, position (0, 15)'s ``pairwise_topk`` call
   against the plain version; (e) ``launch.dryrun.main`` on meta for
   qwen3-0.6b train_4k single and deepseek-v2-lite-16b decode_32k multi;
22. (run after phase 11) the reference's deprecated entry forms on kitti
   2^20: ``trueknn(kitti, 8)`` bitwise equal to phase 4's batch 1
   (answers, ``found``, ``n_tests`` and every round's radius, rows,
   resolved and tests; wall time beside batch 1's), ``brute_knn`` on
   phase 5's rows equal to the brute backend's ``KnnSpec(8)``,
   ``fixed_radius_knn`` at phase 9's radius on those rows equal to a fresh
   ``HybridSpec(8, r)`` index and, as a self-query, to phase 9's first
   batch, ``index.query(q, 8)`` and ``index.query(q, k=8, radius=r0)`` on
   phase 4's warm index equal to ``KnnSpec(8)`` and ``KnnSpec(8,
   start_radius=r0)``; each form's ``DeprecationWarning`` recorded
   exactly once, attributed to this file; both kernels launched;
then the phase seconds (each phase's, and the five slowest), the
kernels line and the device line.

Every check raises, so any failure exits non-zero.  The launch counters
are zeroed just before each entry point (phases 4, 5 and 9-22) and read
just after; a kernel of that path that was not launched fails the run.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
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
#: phase 3: the fused loop's few-row rounds on kitti's collapsed grid (the
#: rows unresolved in batch 2's last two coarse rounds, PERF.md)
FEW_ROWS = (1, 206)
#: k > 32: each register-list size of pairwise_topk (32 * KPL = 64 ...
#: 1024 entries, k = 33 the smallest past one entry a lane) and one k above
#: the largest, which keeps its list in its workspace row
WIDE_KS = (33, 64, 128, 256, 1024, 1100)
WIDE_ROWS = 512  # phase 2's rows a k > 32 case
SEED = 0
FINE_TEST_BUDGET = 1 << 36  # most tests phase 8 gives the fine design
PLAIN_ROWS = 1024  # phase 8: split rounds on at most this many rows vs plain
CHUNK_ROWS = 1 << 18  # phase 11's chunked all-pairs: 4 blocks of the cloud
COUNTED_ROWS = 64  # phase 11: rows of the k > 32 counted rounds held plain
P_MESH = 4  # phases 12-13: model positions, 2^20 points each
MESH_ROUNDS = 24  # configs/trueknn.py: max_rounds
DIST_ROWS = 1 << 16  # configs/trueknn.py: n_queries = 1 << 16
#: phase 13's points a position: 2^21 in all, cut from 2^22 for its host
#: grid builds (27.4 s of the phase's 37.7 s at 2^22; 22.5 s at 2^21,
#: whose sparser cloud takes 7 rounds to 2^22's 5)
GRID_MESH_POINTS = 1 << 19
#: phase 16's trueknn base, cut from the whole 2^20 cloud: its three
#: batch-1 searches (the mutable base, the rebuild, after compact) are
#: host grid builds, 33 s of the phase's 46.2 s at 2^20
MUT_BASE = 1 << 19


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


#: the launch counts' keys for each kernel's launches at k > 32
WIDE = "pairwise_topk k>32"
GWIDE = "grid_round k>32"


def launch_counts():
    """The kernels' launch counts, and each kernel's at k > 32 apart."""
    from repro_torch.kernels import build

    wide = build.WIDE_LAUNCHES
    return {**build.launch_counts(), WIDE: wide["pairwise_topk"],
            GWIDE: wide["grid_round"]}


def kernel_ms(fn, names):
    """Device ms of the kernels whose demangled names match each regular
    expression of ``names`` in one call of ``fn`` (a ``torch.profiler``
    trace); None for a pattern the trace shows no device time for."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        for name in names:
            if re.search(name, ev.key) and us:
                got[name] = got.get(name, 0.0) + us / 1e3
    return {name: got.get(name) for name in names}


def bound(bytes_moved, flops):
    """Least time on the card for the work (ms) and what bounds it."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


class PhaseClock:
    """Host seconds of each phase: ``start`` closes the running phase (its
    ``phase N took`` line) and opens the next; ``stop`` closes it with an
    addendum to that line."""

    def __init__(self):
        self.seconds = {}
        self._n = None

    def start(self, n, title):
        if self._n is not None:
            self.stop()
        log(f"phase {n}: {title}")
        self._n, self._t0 = n, time.perf_counter()

    def stop(self, extra=""):
        took = time.perf_counter() - self._t0
        self.seconds[self._n] = took
        log(f"  phase {self._n} took {took:.1f}s{extra}")
        self._n = None


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
    # k > 32: every register-list size and the row list above it, in L2 on
    # kitti and L1 / L-inf on the subset (d = 3), L2 at d = 16
    m = WIDE_ROWS
    for k in WIDE_KS:
        cases += [
            (f"wide l2 d3 k{k}", kitti[rows[:m]], none(m, kitti), kitti,
             "l2", k, 0.01),
            (f"wide l1 d3 k{k}", sub[srow[:m]] + 0.01, none(m, sub), sub,
             "l1", k, 0.5),
            (f"wide linf d3 k{k} self", sub[srow[:m]], ids(srow[:m]), sub,
             "linf", k, 0.1),
        ]
    cases += [(f"wide l2 d16 k{k} self", wide[wrow], ids(wrow), wide, "l2",
               k, 20.0) for k in (128, 1024)]
    # exact duplicates of point 5 inside one 32-point chunk (64..71),
    # across a chunk boundary (94..97) and on both sides of every range
    # boundary of the kernel's own split at this k
    for k in (64, 256, 1024):
        _, span = split_plan(512, N_SUB, 3, k, "l2", dev)
        dup = sub.clone()
        dup[64:72] = dup[5]
        dup[94:98] = dup[5]
        for b in range(span, N_SUB, span):
            dup[b - 1] = dup[5]
            dup[b] = dup[5]
        cases += [
            (f"wide ties l2 d3 k{k} self", dup[srow], ids(srow), dup, "l2",
             k, 0.05),
            (f"wide ties l1 d3 k{k}", dup[srow], none(512, dup), dup, "l1",
             k, 0.2),
        ]
    # a single-row and an eight-row request: hundreds of ranges a row
    cases += [(f"many ranges l2 d3 k256 Q={m}", kitti[rows[:m]],
               none(m, kitti), kitti, "l2", 256, 0.01) for m in (1, 8)]
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
        if tag.startswith("many ranges"):
            check(s_used >= 100, f"{tag}: S={s_used}, not hundreds")
        log(f"  pairwise_topk {tag}: Q={q.shape[0]} N={p.shape[0]} S={s_used} "
            f"{'bitwise' if bitwise else 'rtol 1e-6'} ok, max|err|={err:g}, "
            f"counts max {int(got[2].max())}")

    # row_mask: masked rows equal the plain version's, the others untouched
    # (k = 128: the warp list of four entries a lane)
    q, qid = kitti[rows].contiguous(), none(ROWS, kitti)
    for k, tag, mask in (
        (32, "all zero", torch.zeros(ROWS, dtype=torch.uint8, device=dev)),
        (32, "every third row",
         (torch.arange(ROWS, device=dev) % 3 == 0).to(torch.uint8)),
        (128, "every third row",
         (torch.arange(ROWS, device=dev) % 3 == 0).to(torch.uint8)),
    ):
        res = []
        for fn in ("kernel", "plain"):
            out = (torch.full((ROWS, k), -1.0, device=dev),
                   torch.full((ROWS, k), -1, dtype=torch.int32, device=dev),
                   torch.full((ROWS,), -1, dtype=torch.int32, device=dev))
            if fn == "kernel":
                topk_engine(q, qid, kitti, 0.01, k=k, row_mask=mask, out=out)
            else:
                pairwise_topk_ref(q, kitti, k, radius2=0.01, query_ids=qid,
                                  row_mask=mask, out=out)
            res.append(out)
        torch.cuda.synchronize()
        for a, b, name in zip(*res, ("d", "idx", "counts")):
            check(torch.equal(a, b), f"row_mask {tag} k={k}: {name} differs")
        untouched = bool((res[0][2][mask == 0] == -1).all())
        check(untouched, f"row_mask {tag} k={k}: an unmasked row was written")
        log(f"  pairwise_topk row_mask {tag}: Q={ROWS} k={k} bitwise ok, "
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
    few = few_row_rounds(dev, pts, grid, r2, heaviest, k)
    return (sched, pts), worst, heavy, few


def few_row_rounds(dev, pts, grid, r2, t, k):
    """The fused loop's few-row rounds on the heaviest grid as the main
    path runs them: every row of the cloud in the call, ``FEW_ROWS`` of
    them unresolved (a seeded draw), so the kernel splits each active tile
    across the card.  Each held bitwise against the plain version (every
    output and flag), then timed on fresh state (the wrapper's cell sort
    included), and once under the profiler for the split pass (the split
    instantiation alone) and the merge apart, with the (T, S) the launch
    reports.  Returns the kernels-line rows."""
    import torch

    from repro_torch.core.fixed_radius import (
        _launch,
        coarse_design,
        grid_round,
        grid_round_plain,
    )

    n, d = pts.shape
    check(coarse_design(grid), "few-row rounds: the grid is not coarse")
    qid = torch.arange(n, dtype=torch.int32, device=dev)
    pick = torch.as_tensor(np.random.default_rng(21).choice(
        n, max(FEW_ROWS), replace=False), device=dev)
    split_re = r"grid_round_tiled_kernel<.*true>"
    names = ("d2", "idx", "found", "n_tests", "unres", "res_round",
             "executed")
    rows_out = []
    for m in FEW_ROWS:
        unres0 = torch.zeros(n, dtype=torch.uint8, device=dev)
        unres0[pick[:m]] = 1

        def call(fn):
            st = [torch.full((n, k), -1.0, device=dev),
                  torch.full((n, k), -1, dtype=torch.int32, device=dev),
                  torch.full((n,), -1, dtype=torch.int32, device=dev),
                  torch.zeros(1, dtype=torch.int64, device=dev),
                  unres0.clone(),
                  torch.full((n,), -1, dtype=torch.int32, device=dev),
                  torch.zeros(1, dtype=torch.int32, device=dev)]
            torch.cuda.synchronize()
            go = lambda: fn(pts, grid, pts, qid, r2, k,  # noqa: E731
                            out=tuple(st[:3]), tests=st[3], unres=st[4],
                            res_round=st[5], t=t, executed=st[6])
            return st, go

        got, go = call(grid_round)
        go()
        want, go_p = call(grid_round_plain)
        t0 = time.perf_counter()
        go_p()
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        for x, y, name in zip(got, want, names):
            check(torch.equal(x, y), f"few-row round ({m} rows): {name} "
                  f"differs")
        n_tests = int(got[3].item())
        times = []
        for _ in range(3):
            _, go = call(grid_round)
            times.append(_events_ms(go))
        ms = statistics.median(times)
        # the wrapper's launch (the grid is coarse), with the plan read back
        plan = torch.full((2,), -1, dtype=torch.int32, device=dev)
        _, go = call(functools.partial(_launch, tiled=True, plan=plan))
        split = kernel_ms(go, (split_re, "grid_round_merge_kernel"))
        tiles, s = plan.tolist()
        check(tiles == 1 and s > 1, f"few-row round ({m} rows): T={tiles} "
              f"S={s}, not split")
        # the rows' flags are read across the call (unres, nq bytes); the
        # candidates they test once each (slot, cell coords, point); each
        # row's query, id and outputs
        b = bound(n + min(n_tests, n) * (4 + 8 * d)
                  + m * (d * 4 + 4 + k * 8 + 4 + 4 + 1), n_tests * 3 * d)
        def fmt(v):
            return "not measured" if v is None else f"{v:.3f} ms"

        log(f"  grid_round fused few-row t={t} rows={m} of {n} "
            f"res={grid.res} cap={grid.cap} T={tiles} S={s} "
            f"n_tests={n_tests}: bitwise equal to the plain version "
            f"({', '.join(names)}); kernel {ms:.3f} ms (split pass "
            f"{fmt(split[split_re])}, merge "
            f"{fmt(split['grid_round_merge_kernel'])}), plain {p_ms:.3f} ms,"
            f" bound {b[0]:.6f} ms ({b[1]})")
        rows_out.append(shape_row(
            f"fused few-row round rows={m} of Q=2^20 k={k} res={grid.res} "
            f"cap={grid.cap}", ms, p_ms, b, n_tests=n_tests, tiles=tiles,
            splits=s, split_pass_ms=split[split_re],
            merge_ms=split["grid_round_merge_kernel"]))
    return rows_out


# -- phase 4: the main path ---------------------------------------------------


def phase_main(dev, kitti_np, rng):
    import torch

    from repro_torch import KnnSpec, build_index
    from repro_torch.core.result import strip_self_knn
    from repro_torch.kernels import build

    build.reset_launches()
    t0 = time.perf_counter()
    index = build_index(kitti_np, backend="trueknn", device=dev)
    batches, walls = [], []
    for b in (1, 2):
        t1 = time.perf_counter()
        res = index.query(None, KnnSpec(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        batches.append(res)
        walls.append(wall)
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
    counts = launch_counts()
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
    return index, batches, counts, radius, walls


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
    counts = launch_counts()
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
        # outputs of their own: merged into split 0's rows, every timed
        # merge after the first would start from the merged list
        outs = tuple(torch.empty_like(x[0]) for x in part)
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

    # k > 32: a 4096-row self-query at each warp-list size, a single-row
    # and an eight-row request (hundreds of ranges), and the shape of phase
    # 2's range l2 d3 k300 call on phase 5's first 512 rows; rows of their
    # own seed, so the shared draws of later phases stay as they were
    self_rows = torch.as_tensor(np.random.default_rng(20).choice(
        n, ROWS, replace=False), device=dev)
    q_self = p[self_rows].contiguous()
    qid_self = self_rows.to(torch.int32)
    qid_none = torch.full((ROWS,), n, dtype=torch.int32, device=dev)
    wide = [(f"Q=4096 N=2^20 d=3 k={kw} self-query", q_self, qid_self, kw)
            for kw in (64, 128, 256, 1024)]
    wide += [(f"Q={m} N=2^20 d=3 k=256 request", q_self[:m].contiguous(),
              qid_none[:m], 256) for m in (1, 8)]
    wide.append(("Q=512 N=2^20 d=3 k=300 range (phase 5's rows)",
                 q[:512].contiguous(), qid_none[:512], 300))
    wide_rows = []
    for tag, qq, qi, kw in wide:
        m = qq.shape[0]
        w_k = median_ms(lambda: topk_engine(qq, qi, p, thr, k=kw), 3, sync)
        w_p = median_ms(lambda: pairwise_topk_ref(qq, p, kw, radius2=thr,
                                                  query_ids=qi), 1, sync,
                        warmup=False)
        w_s, w_1, w_2 = split_ms(qq, qi, kw, thr)
        part_bytes = w_s * m * (kw * 8 + 4)
        w_b = bound(m * d * 4 + n * d * 4 + m * 4 + m * (kw * 8 + 4),
                    m * n * 3 * d)
        b_1 = bound(m * d * 4 + n * d * 4 + m * 4 + part_bytes,
                    m * n * 3 * d)
        # the merge of sorted lists must read a row's k entries (wherever
        # they come from), each split's head and count, and write the row;
        # entries at or above the gate it never reads
        b_2 = (bound(m * (kw * 8 + w_s * 8 + kw * 8 + 4), 0) if w_s > 1
               else None)
        log(f"  pairwise_topk {tag}: kernel {w_k:.3f} ms (S={w_s}: first "
            f"pass {w_1:.3f} ms, bound {b_1[0]:.4f} ms ({b_1[1]}); merge "
            f"{w_2:.3f} ms, bound "
            f"{f'{b_2[0]:.4f} ms ({b_2[1]})' if b_2 else '-'}), plain "
            f"{w_p:.3f} ms, bound {w_b[0]:.4f} ms ({w_b[1]})")
        wide_rows.append(shape_row(
            tag, w_k, w_p, w_b, splits=w_s, first_pass_ms=w_1,
            first_pass_bound_ms=b_1[0], merge_ms=w_2,
            merge_bound_ms=b_2[0] if b_2 else None))

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
            (h_k, None, h_bound, h_tests), wide_rows)


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
    sort of the coarse design included), the state it leaves and, coarse,
    the (T, S) the launch reports (else None)."""
    import torch

    from repro_torch.core.fixed_radius import _launch

    n, k = state[0].shape
    qid = torch.arange(n, dtype=torch.int32, device=pts.device)
    plan = (torch.full((2,), -1, dtype=torch.int32, device=pts.device)
            if tiled else None)
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
            executed=st[-1] if fused else None, plan=plan)))
        if times[-1] > 200.0:
            break
    return (statistics.median(times), st,
            tuple(plan.tolist()) if tiled else None)


def _round_once(pts, grid, r2, state, plain=False, **kw):
    """One launch of the coarse design (``kw`` to ``_launch``, such as a
    forced split) or, with ``plain``, the plain version, on fresh copies of
    ``state``; the state it leaves, laid out as ``_design_ms``'s."""
    import torch

    from repro_torch.core.fixed_radius import _launch, grid_round_plain

    n, k = state[0].shape
    qid = torch.arange(n, dtype=torch.int32, device=pts.device)
    st = [x.clone() for x in state] + [
        torch.zeros(1, dtype=torch.int64, device=pts.device),
        torch.zeros(1, dtype=torch.int32, device=pts.device)]
    fused = len(state) == 5
    args = dict(out=tuple(st[:3]), tests=st[-2],
                unres=st[3] if fused else None,
                res_round=st[4] if fused else None, t=0,
                executed=st[-1] if fused else None)
    if plain:
        grid_round_plain(pts, grid, pts, qid, r2, k, **args)
    else:
        _launch(pts, grid, pts, qid, r2, k, True, **args, **kw)
    torch.cuda.synchronize()
    return st


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
                c_ms, c_st, (tiles, splits) = _design_ms(pts, grid, r2,
                                                         state, True)
                n_tests = int(c_st[-2].item())
                f_ms = None
                if n_tests <= FINE_TEST_BUDGET:
                    f_ms, f_st, _ = _design_ms(pts, grid, r2, state, False)
                    for x, y in zip(c_st, f_st):
                        check(torch.equal(x, y), f"designs differ: {cloud} "
                              f"t={t} {mode}")
                pick = coarse_design(grid)
                # (T, S) as the coarse launch reports them: a round over all
                # 2^20 rows fills the card unsplit; one on a few hundred
                # rows is split
                if pick and rows == N_MAIN:
                    check(splits == 1, f"{cloud} t={t}: every-row round split")
                if pick and rows <= 256:
                    check(splits > 1,
                          f"{cloud} t={t}: few-row round not split")
                held = ""
                if splits > 1:
                    # the split round against the unsplit one (S forced to
                    # 1) and, on few rows, against the plain version
                    refs = {"S=1": _round_once(pts, grid, r2, state, splits=1)}
                    if rows <= PLAIN_ROWS:
                        refs["plain"] = _round_once(pts, grid, r2, state,
                                                    plain=True)
                    for name, ref in refs.items():
                        for x, y in zip(c_st, ref):
                            check(torch.equal(x, y), f"{cloud} t={t} {mode}: "
                                  f"the split round differs from {name}")
                    held = f" (bitwise equal to {' and '.join(refs)})"
                if f_ms is not None:
                    acc = tot[mode]
                    for j, v in enumerate((c_ms if pick else f_ms,
                                           min(c_ms, f_ms), f_ms, c_ms)):
                        acc[j] += v
                fine = "not run" if f_ms is None else f"{f_ms:.3f} ms"
                log(f"  {cloud} t={t} {mode}: rows={rows} res={grid.res} "
                    f"cap={grid.cap} H={grid.table_size} "
                    f"slots={stencil_slots(grid):.6g} n_tests={n_tests}: "
                    f"coarse (T={tiles} S={splits}{held}) {c_ms:.3f} ms, "
                    f"fine {fine}; the wrapper takes "
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
    counts = launch_counts()
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
    return index, h1


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
    from repro_torch.core.fixed_radius import _launch, grid_round_plain
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

    # the counted range's rounds alone, at full width: its first round
    # (k = 32), its second (the next power of two of the fullest ball) and
    # k = 1024, the largest register list; past k = 32 both designs (the
    # wrapper's coarse one and the fine one, a warp a query), held bitwise
    # equal to each other at full width and to the plain version on
    # COUNTED_ROWS rows
    pts = fr_index._pts_t
    n, d = pts.shape
    grid, _ = fr_index._grid_for(radius)
    qid = torch.arange(n, dtype=torch.int32, device=dev)
    r2 = float(np.float32(radius) ** 2)
    rounds = []
    names = ("d2", "idx", "found", "n_tests")
    for k in sorted({32, counted_k(csr["fixed_radius"]), 1024}):
        outs = {}
        for design in (("coarse", "fine") if k > 32 else ("coarse",)):
            out = (torch.empty((n, k), device=dev),
                   torch.empty((n, k), dtype=torch.int32, device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev))
            tests = torch.zeros(1, dtype=torch.int64, device=dev)

            def run(out=out, tests=tests, tiled=design == "coarse"):
                tests.zero_()
                _launch(pts, grid, pts, qid, r2, k, tiled, out=out,
                        tests=tests)

            first = median_ms(run, 1, torch.cuda.synchronize, warmup=False)
            ms = first if first > 2000.0 or design == "fine" else median_ms(
                run, 3, torch.cuda.synchronize, warmup=False)
            outs[design] = (*out, tests)
            n_tests = int(tests.item())
            b = bound(n * d * 4 + grid.table_size * grid.cap * 4
                      + (n + 1) * d * 4 + n * 4 + n * k * 8 + n * 4,
                      n_tests * 3 * d)
            held = ""
            if k > 32:
                # the design on the first rows alone, against the plain
                # version and against the same rows of the full-width call
                sub = slice(0, COUNTED_ROWS)
                qs, qi = pts[sub].contiguous(), qid[sub].contiguous()
                runs = []
                for fn in (lambda **kw: _launch(pts, grid, qs, qi, r2, k,
                                                design == "coarse", **kw),
                           lambda **kw: grid_round_plain(pts, grid, qs, qi,
                                                         r2, k, **kw)):
                    o = tuple(torch.empty_like(x[sub]) for x in out)
                    tt = torch.zeros(1, dtype=torch.int64, device=dev)
                    fn(out=o, tests=tt)
                    runs.append((*o, tt))
                torch.cuda.synchronize()
                for x, y, z, name in zip(*runs, [x[sub] for x in out] + [None],
                                         names):
                    check(torch.equal(x, y), f"counted range k={k} {design}:"
                          f" {name} differs from the plain version")
                    check(z is None or torch.equal(x, z), f"counted range "
                          f"k={k} {design}: {name} differs at full width")
                held = (f"; rows 0-{COUNTED_ROWS - 1} bitwise equal to the "
                        f"plain version")
            rounds.append((k, design, ms, b, n_tests))
            log(f"  counted range round k={k} {design} Q={n} res={grid.res} "
                f"cap={grid.cap} n_tests={n_tests}: kernel {ms:.3f} ms, "
                f"bound {b[0]:.4f} ms ({b[1]}){held}")
        if "fine" in outs:
            for x, y, name in zip(outs["coarse"], outs["fine"], names):
                check(torch.equal(x, y), f"counted range k={k}: the designs' "
                      f"{name} differ")
            log(f"  counted range round k={k}: both designs bitwise equal at "
                f"full width")
        del outs
        torch.cuda.empty_cache()

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
    uniform 2^21 cloud and 2^16 of its rows, held against the dense engine
    (``backend="distributed"``) on the same rows.  Not on kitti: the
    stacked grids share one (table_size, cap), the largest over the
    shards, and kitti's shards straddle the sizing probe's collapse (one
    shard asks for a fine table, another for a 2^19 cap), so the shared
    shape needs up to 2^40 slots a shard; on a uniform cloud every shard
    asks for the same shape."""
    from repro_torch import KnnSpec, build_index, make_dataset
    from repro_torch.core.distributed_grid import distributed_trueknn_grid

    n = P_MESH * GRID_MESH_POINTS
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
    # each timed call rewrites the same selected rows of its own outputs
    ms = median_ms(lambda: topk_engine(q, none, blk, thr, k=k, metric=metric,
                                       row_mask=mask, out=got), 3, sync)
    plain = median_ms(lambda: pairwise_topk_ref(
        q, blk, k, radius2=thr, query_ids=none, metric=metric, row_mask=mask,
        out=want), 1, sync, warmup=False)
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
    """Phase 16: ``backend="mutable"`` over a trueknn base of kitti 2^19:
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
    mut = build_index(make_dataset("kitti", MUT_BASE), backend="mutable",
                      base_backend="trueknn", delta_rows=2048,
                      auto_compact="off", device=dev)
    extra = make_dataset("kitti", 1 << 14, seed=1)
    t0 = time.perf_counter()
    ids = np.concatenate([mut.insert(extra[i:i + 2048])
                          for i in range(0, 1 << 14, 2048)])
    secs["inserts"] = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    dead = np.concatenate([rng.choice(MUT_BASE, 32, replace=False),
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
#: phase 18: kNN-LM datastore rows, cut from 2^20 (its host draw and PCA
#: took 23.9 s of the phase's 46.0 s)
LM_N = 1 << 18
LM_D = 1024  # Khandelwal et al.'s key width
LM_VOCAB = 32768
LAUNCH_SMALL_N = 1 << 16  # phase 18: the launcher's graph and DBSCAN runs
#: phase 18: the launcher's kNN open loop, cut from 2^20 (11.1 s, nearly
#: all its warm batch's host grid builds)
LAUNCH_KNN_N = 1 << 19


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


def same_rows(tag, results, direct, found=True):
    """Tickets of consecutive row blocks against one direct query of all
    the rows: kNN distances, indices and (unless ``found`` is False) found
    where the direct answer has it, or the range CSR's counts, indices and
    distances, bitwise."""
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
    if found and direct.found is not None:
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

    # (a) the open loop on its own server, so its bucket is its own.  The
    # batches it forms follow the arrival times, and each batch starts at
    # the warm radius that the batches before it left (an EMA of their
    # resolved radii), so a row's found (its count at the round it
    # resolved in) depends on its batch; each batch the server runs is
    # recorded to hold found against a direct query from the same start
    solo = NeighborServer(indexes={"lidar": lidar}, max_batch=SERVE_BATCH,
                          cache_size=0)
    served = []  # (rows, result) of each batch the server ran
    plan_for = solo._plan_for

    def recording_plan_for(*a, **kw):
        plan = plan_for(*a, **kw)

        def run(rows):
            res = plan(rows)
            served.append((np.array(rows, copy=True), res))
            return res
        return run

    solo._plan_for = recording_plan_for
    (results, wall_a, lat), wall, counts, reads = drive(
        "open loop", lambda: poisson_open_loop(
            solo, q5, KnnSpec(8), SERVE_RATE, np.random.default_rng(17),
            index="lidar", timeout=600.0),
        ("grid_round",))
    del solo._plan_for
    check(len(results) == ROWS, f"open loop served {len(results)} of {ROWS}")
    direct = lidar.query(q5, KnnSpec(8))
    same_rows("open loop vs direct", results, direct, found=False)
    found_of = {}  # a row's coordinates -> the found its batches gave it
    for rows, res in served:
        again = lidar.query(rows, KnnSpec(8, start_radius=res.start_radius))
        for key in ("dists", "idxs", "found"):
            check(np.array_equal(getattr(res, key), getattr(again, key)),
                  f"open loop batch vs a direct query from its start radius:"
                  f" {key}")
        for row, f in zip(rows, res.found):
            found_of.setdefault(row.tobytes(), set()).add(int(f))
    for row, r in zip(q5, results):
        check(int(r.found[0]) in found_of[np.float32(row).tobytes()],
              "open loop ticket's found vs its batch's row")
    starts = sorted({float(res.start_radius) for _, res in served})
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
        f"direct query of its row (distances, indices) and its found to "
        f"its batch's, each of the {len(served)} batches bitwise equal to a "
        f"direct query from its start radius (start radii {starts}); "
        f"launches {counts}, host reads {reads}")
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
        dead = np.concatenate([minted[:64], live[live < MUT_BASE][:64]])
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
    a kNN-LM datastore of 2^18 synthetic hidden states of width 1024 with
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
        ("knn open loop", ["--mode", "knn", "--n", str(LAUNCH_KNN_N),
                           "--arrival",
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


# -- phase 19: the LM stack ---------------------------------------------------


LM_ARCH = "qwen3-0.6b"  # phase 19 (a): full width and depth
LM_PROMPT = 128  # tokens a prompt in the consistency checks
LM_STEPS = 16  # teacher-forced decode steps checked against forward
#: phase 19 (a) server; 32 requests, cut from 64: the server and the direct
#: decode loop it is held against took ~52 s of the phase's 88.4 s
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW = 32, 8, 64
STORE_ROWS, STORE_SEQ = 256, 1024  # phase 19 (c): 2^18 tokens of the stream
#: f32 prefill logits on the card (TF32 off) vs the CPU: the same f32
#: formula with other summation orders through 28 layers; a TF32 or bf16
#: product (10 or 8 mantissa bits) would err by about 1e-2 or more on
#: logits of standard deviation ~1
F32_LOGIT_ATOL = 2e-3
#: bf16 decode vs bf16 forward: the same bf16 model, but the two paths'
#: products round their bf16 outputs at other shapes, so the residual
#: stream drifts by some bf16 steps (2^-8 relative) over the layers; on
#: logits of standard deviation ~1 the mean error stays under 0.02.  The
#: largest stays under 0.5: where a token's k-th and next router
#: probabilities lie within that drift, its MoE layer picks another
#: expert in one path (deepseek-v2-lite: 0.27 in one run)
BF16_LOGIT_MEAN, BF16_LOGIT_MAX = 0.02, 0.5
#: float32 decode vs float32 forward (TF32 off): the reference's own
#: tolerance for it (tests/test_models.py:86, atol 1e-3)
F32_DECODE_MEAN, F32_DECODE_MAX = 1e-4, 1e-3


def forward_logits(model, cfg, tokens, pe, rows):
    """Logits of ``forward`` at positions ``rows`` (f32, (B, len, V))."""
    from repro_torch.models import forward
    from repro_torch.models.model import _unembed_weight

    x, _ = forward(model, cfg, tokens, pe)
    return (x[:, rows] @ _unembed_weight(model)).float()


def logit_gap(tag, got, want, mean_tol, max_tol):
    d = (got - want).abs()
    mean, top = float(d.mean()), float(d.max())
    check(mean <= mean_tol and top <= max_tol,
          f"{tag}: |logits diff| mean {mean:.3g} max {top:.3g} beyond "
          f"{mean_tol} / {max_tol}")
    return mean, top


def decode_vs_forward(model, cfg, dev, tokens, pe,
                      tol=(BF16_LOGIT_MEAN, BF16_LOGIT_MAX)):
    """Prefill ``tokens[:, :-LM_STEPS]``, then decode its last LM_STEPS
    tokens one at a time (teacher forced); the prefill's logits and each
    step's against ``forward`` over the whole sequence.  Returns the
    mean and max |diff|, the greedy agreement and the seconds of the
    prefill and of the decode steps."""
    import torch

    from repro_torch.models import decode_step, make_decode_caches, prefill

    b, s = tokens.shape
    p_len = 0 if pe is None else pe.shape[1]
    plen = s - LM_STEPS
    caches = make_decode_caches(cfg, b, p_len + s + 1, device=dev)
    tok = torch.as_tensor(tokens, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = prefill(model, cfg, tok[:, :plen], caches, prefix_embeds=pe)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = [lg]
    for i in range(LM_STEPS):
        lg, caches = decode_step(model, cfg, tok[:, plen + i:plen + i + 1],
                                 p_len + plen + i, caches)
        got.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = torch.stack(got, 1)
    want = forward_logits(model, cfg, tok, pe,
                          slice(p_len + plen - 1, p_len + s))
    mean, top = logit_gap(f"{cfg.name} {cfg.compute_dtype} decode vs "
                          "forward", got, want, *tol)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return mean, top, agree, t1 - t0, (t2 - t1) / LM_STEPS


def f32_copy(model, cfg, device):
    """The same weights in float32 (a float32 config) on ``device``."""
    import dataclasses

    import torch

    from repro_torch.models import LM

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    m = LM(cfg32, "meta").to_empty(device=device)
    with torch.no_grad():
        for dst, src in zip(m.parameters(), model.parameters()):
            dst.copy_(src.float())
    return m, cfg32


def timed(fn, times):
    """``fn`` that also records its seconds to a device sync."""
    import torch

    def call(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    return call


def pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def phase_lm_qwen(dev, rng):
    """Phase 19 (a): Qwen3-0.6B at full width and depth in bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params
    from repro_torch.models import make_decode_caches, prefill
    from repro_torch.serve import BatchedServer, ServeConfig

    out = {}
    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    torch.cuda.synchronize()
    built = sum(p.numel() for p in model.parameters())
    check(built == cfg.param_count(), f"param_count {cfg.param_count()} != "
          f"{built} built")
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, vocab "
        f"{cfg.vocab_size} -> {cfg.padded_vocab}, {built} parameters "
        f"(= param_count) in {cfg.param_dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")

    # float32 copy on the card (TF32 off) vs the CPU
    tokens = rng.integers(0, cfg.vocab_size, (2, LM_PROMPT))
    m32, cfg32 = f32_copy(model, cfg, dev)
    cpu32, _ = f32_copy(model, cfg, torch.device("cpu"))
    with torch.inference_mode():
        t0 = time.perf_counter()
        lg_card, _ = prefill(m32, cfg32, tokens, make_decode_caches(
            cfg32, 2, LM_PROMPT + 1, device=dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lg_cpu, _ = prefill(cpu32, cfg32, tokens, make_decode_caches(
            cfg32, 2, LM_PROMPT + 1, device="cpu"))
        cpu_s = time.perf_counter() - t0
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    check(err <= F32_LOGIT_ATOL, f"f32 prefill card vs CPU {err}")
    log(f"  float32 copy, prefill 2 x {LM_PROMPT}: card (TF32 off) "
        f"{card_s:.4f}s vs CPU {cpu_s:.4f}s, max |logit diff| {err:.3g} "
        f"(<= {F32_LOGIT_ATOL}); logit std {float(lg_cpu.std()):.3f}")
    del m32, cpu32, lg_card, lg_cpu
    torch.cuda.empty_cache()

    # bf16 decode vs forward
    with torch.inference_mode():
        seq = rng.integers(0, cfg.vocab_size, (2, LM_PROMPT + LM_STEPS))
        mean, top, agree, pre_s, step_s = decode_vs_forward(model, cfg, dev,
                                                            seq, None)
    log(f"  bf16 decode vs forward, 2 x {LM_PROMPT} + {LM_STEPS} teacher-"
        f"forced steps: |logit diff| mean {mean:.4g} max {top:.4g} (<= "
        f"{BF16_LOGIT_MEAN} / {BF16_LOGIT_MAX}), greedy agreement "
        f"{agree:.4f}; prefill {pre_s * 1e3:.2f} ms, decode step "
        f"{step_s * 1e3:.2f} ms")
    out["decode_vs_forward"] = (mean, top, agree)

    # BatchedServer on the card against the direct loop
    lens = rng.integers(16, 257, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    server = BatchedServer(cfg, model, ServeConfig(batch_slots=SERVE_SLOTS))
    pre_t, dec_t = [], []
    server.prefill = timed(server.prefill, pre_t)
    server.decode = timed(server.decode, dec_t)
    for p in prompts:
        server.submit(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs = server.run(max_new_tokens=SERVE_NEW)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    held = base / 2**30
    n_tok = sum(len(o) for o in outs)
    check(len(outs) == SERVE_REQUESTS and all(len(o) == SERVE_NEW
                                              for o in outs),
          "server completions")
    direct = []
    with torch.inference_mode():
        for g in range(0, SERVE_REQUESTS, SERVE_SLOTS):
            batch = prompts[g:g + SERVE_SLOTS]
            plen = max(len(p) for p in batch)
            toks = np.zeros((len(batch), plen), np.int64)
            for i, p in enumerate(batch):
                toks[i, plen - len(p):] = p
            caches = make_decode_caches(cfg, len(batch), plen + SERVE_NEW + 1,
                                        device=dev)
            lg, caches = prefill(model, cfg, toks, caches)
            rows = []
            for i in range(SERVE_NEW):
                tok = torch.argmax(lg, -1)[:, None]
                rows.append(tok)
                if i + 1 < SERVE_NEW:
                    lg, caches = decode_step(model, cfg, tok, plen + i,
                                             caches)
            direct += torch.cat(rows, 1).tolist()
    check(outs == direct, "server completions vs the direct loop")
    out.update(serve_s=wall, tokens_per_s=n_tok / wall)
    log(f"  BatchedServer: {SERVE_REQUESTS} requests (prompts "
        f"{int(lens.min())}-{int(lens.max())} tokens), {SERVE_SLOTS} slots, "
        f"{SERVE_NEW} new tokens greedy: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tokens/s; prefill ms p50 {pct(pre_t, 50):.2f} "
        f"p99 {pct(pre_t, 99):.2f} ({len(pre_t)} batches); decode step ms "
        f"p50 {pct(dec_t, 50):.2f} p99 {pct(dec_t, 99):.2f} ({len(dec_t)} "
        f"steps); peak {peak:.2f} GiB ({held:.2f} GiB held before it: the "
        f"weights and earlier phases' tensors); every completion equal to "
        f"the direct prefill + decode_step loop")
    busy = decode_trace(model, cfg, dev, prompts[:SERVE_SLOTS])
    if busy is None:
        log("  decode trace: the profiler saw no device time")
    else:
        dev_ms, n_kernels = busy
        step_ms = pct(dec_t, 50)
        log(f"  decode trace (torch.profiler, 8 steps at batch "
            f"{SERVE_SLOTS}): {dev_ms:.3f} ms of kernels and {n_kernels:.0f} "
            f"kernel launches a step; against the server's p50 step "
            f"{step_ms:.2f} ms the card is busy {dev_ms / step_ms:.1%}")
        out.update(decode_kernel_ms=dev_ms, decode_kernels=n_kernels)
    return model, cfg, out


def decode_trace(model, cfg, dev, prompts):
    """Device time and kernel launches per decode step, from a
    ``torch.profiler`` trace of 8 steps after a prefill of ``prompts``;
    None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, make_decode_caches, prefill

    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    steps = 8
    with torch.inference_mode():
        caches = make_decode_caches(cfg, len(prompts), plen + steps + 2,
                                    device=dev)
        lg, caches = prefill(model, cfg, toks, caches)
        tok = torch.argmax(lg, -1)[:, None]
        lg, caches = decode_step(model, cfg, tok, plen, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                tok = torch.argmax(lg, -1)[:, None]
                lg, caches = decode_step(model, cfg, tok, plen + 1 + i,
                                         caches)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        return None
    return dev_us / 1e3 / steps, sum(e.count for e in kernels) / steps


def phase_lm_archs(dev, rng):
    """Phase 19 (b): every other architecture at full width, its depth cut
    to one period plus the leading dense layers (SmolLM-135M whole)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    out = {}
    for name, full in sorted(ARCHS.items()):
        if name == LM_ARCH:
            continue
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        depth = (full.n_layers if name == "smollm-135m"
                 else full.period + full.first_k_dense)
        # dropless capacity for the consistency check, as the reference's
        # own decode-vs-forward test sets it: a token's experts then do
        # not depend on how many tokens share the call
        cf = float(full.n_experts) if full.n_experts else \
            full.moe_capacity_factor
        cfg = dataclasses.replace(full, n_layers=depth,
                                  moe_capacity_factor=cf)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        n = sum(p.numel() for p in model.parameters())
        plen = LM_PROMPT
        if "local" in full.pattern:  # prompts longer than the window: the
            plen = full.local_window + LM_PROMPT  # ring wraps
        if full.family == "ssm":
            plen = 2 * full.ssm_chunk  # two SSD chunks in the prefill
        seq = rng.integers(0, cfg.vocab_size, (2, plen + LM_STEPS))
        pe = None
        if cfg.prefix_len:
            pe = (torch.randn((2, cfg.prefix_len, cfg.d_model), device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(SEED)) * 0.02)
        with torch.inference_mode():
            mean, top, agree, pre_s, step_s = decode_vs_forward(
                model, cfg, dev, seq, pe)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        # the float32 copy of the same weights, to the reference's
        # tolerance: tells a fault from bf16 rounding
        m32, cfg32 = f32_copy(model, cfg, dev)
        del model
        with torch.inference_mode():
            mean32, top32, agree32, _, _ = decode_vs_forward(
                m32, cfg32, dev, seq, None if pe is None else pe.float(),
                tol=(F32_DECODE_MEAN, F32_DECODE_MAX))
        del m32
        cut = (f"reduced: n_layers {full.n_layers} -> {depth}"
               if depth != full.n_layers else "full depth")
        log(f"  {name}: {cut}; d_model {cfg.d_model}, {n} parameters"
            + (f", {cfg.n_experts} experts top-{cfg.experts_per_token}, "
               f"capacity factor {cf:g} (dropless)" if cfg.n_experts else "")
            + (f", {cfg.prefix_len} prefix embeds" if pe is not None else "")
            + f"; prompts 2 x {plen}: |logit diff| mean {mean:.4g} max "
            f"{top:.4g}, greedy agreement {agree:.4f}; prefill "
            f"{pre_s * 1e3:.2f} ms, decode step {step_s * 1e3:.2f} ms; wall "
            f"{wall:.2f}s, peak {peak:.2f} GiB above what was held before; "
            f"float32 copy: mean "
            f"{mean32:.3g} max {top32:.3g}, agreement {agree32:.4f}")
        out[name] = {"wall_s": wall, "peak_gib": peak, "mean": mean,
                     "max": top, "agree": agree, "f32_max": top32}
        torch.cuda.empty_cache()
    return out


def phase_lm_store(dev, model, cfg, tally):
    """Phase 19 (c): a kNN-LM datastore of Qwen3-0.6B's own final hidden
    states over 2^18 tokens of the synthetic stream; ``knn_logprobs`` on
    4096 rows of fresh tokens at the padded vocab."""
    import torch

    from repro_torch import KnnSpec
    from repro_torch.core.knnlm import build_datastore, knn_logprobs
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import forward

    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=STORE_SEQ,
        global_batch=STORE_ROWS, seed=SEED))
    t0 = time.perf_counter()
    data = stream.batch_at(0)
    queries = stream.batch_at(1)["tokens"][: ROWS // STORE_SEQ]
    gen_s = time.perf_counter() - t0

    def hidden(tokens, chunk=16):
        outs = []
        with torch.inference_mode():
            for i in range(0, len(tokens), chunk):
                x, _ = forward(model, cfg, tokens[i:i + chunk])
                outs.append(x.float().reshape(-1, cfg.d_model).cpu())
        return torch.cat(outs).numpy()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hid = hidden(data["tokens"])
    q_hid = hidden(queries)
    fwd_s = time.perf_counter() - t0
    n = hid.shape[0]
    check(hid.shape == (STORE_ROWS * STORE_SEQ, cfg.d_model)
          and np.isfinite(hid).all(), "hidden states")
    store, build_s, _ = counted(
        "kNN-LM build", lambda: build_datastore(
            hid, data["labels"].reshape(-1), device=dev), tally, need=())
    del hid
    seen = []
    query = store.index.query

    def keep(*a, **kw):
        res = query(*a, **kw)
        seen.append(res)
        return res

    store.index.query = keep
    try:
        probs, wall, counts = counted(
            "knn_logprobs (LM states)",
            lambda: knn_logprobs(store, q_hid, cfg.padded_vocab, k=8), tally,
            need=("pairwise_topk", "grid_round"))
    finally:
        del store.index.query
    check(probs.shape == (ROWS, cfg.padded_vocab)
          and np.isfinite(probs).all(), "kNN-LM distribution shape")
    sums = probs.sum(1, dtype=np.float64)
    check(np.abs(sums - 1.0).max() <= 1e-5, "kNN-LM rows sum to 1")
    retrieval = seen[0]
    direct = store.index.query(store.projector(q_hid), KnnSpec(8))
    check(np.array_equal(retrieval.dists, direct.dists)
          and np.array_equal(retrieval.idxs, direct.idxs),
          "kNN-LM retrieval vs a direct query")
    log(f"  kNN-LM on {cfg.name}'s final hidden states: {n} tokens of the "
        f"synthetic stream ({STORE_ROWS} x {STORE_SEQ}, drawn in "
        f"{gen_s:.2f}s), forward in bf16 and to the host in {fwd_s:.2f}s; "
        f"PCA to 3-D and a trueknn index on the card in {build_s:.2f}s; "
        f"knn_logprobs on {ROWS} rows at vocab {cfg.padded_vocab}: "
        f"{wall:.4f}s, launches {counts}; retrieval bitwise equal to a "
        f"direct query, rows sum to 1 within {np.abs(sums - 1.0).max():.2e};"
        f" start {retrieval.timings.get('start_radius_source')}, rounds "
        f"{retrieval.n_rounds}")
    return {"stream_s": gen_s, "hidden_s": fwd_s, "store_build_s": build_s,
            "knn_logprobs_s": wall}


def phase_lm(dev, tally):
    """Phase 19: the LM stack on the card (see the module docstring)."""
    import torch

    rng = np.random.default_rng(SEED)
    out = {}
    t0 = time.perf_counter()
    model, cfg, out["qwen"] = phase_lm_qwen(dev, rng)
    out["qwen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["store"] = phase_lm_store(dev, model, cfg, tally)
    out["store_s"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["archs"] = phase_lm_archs(dev, rng)
    out["archs_s"] = time.perf_counter() - t0
    return out


# -- phase 20: training -------------------------------------------------------


TRAIN_BATCH, TRAIN_SEQ = 8, 1024  # phase 20 (a): two loss chunks of 512
TRAIN_STEPS = 30  # phase 20 (a): Qwen3-0.6B steps
GRAD_ROWS = 2  # phase 20 (b): one 2 x LM_PROMPT batch, card vs CPU
ARCH_BATCH, ARCH_SEQ, ARCH_STEPS = 4, 128, 3  # phase 20 (c)
CKPT_AT, CKPT_STEPS = 4, 6  # phase 20 (d): save at step 4, replay 4..5
#: (b) float32 gradients, card (TF32 off) vs CPU, each leaf's max |diff|
#: over its max |g|: the same formulas with other summation orders in
#: the products and the backward's reductions through 28 layers (the
#: CPU tests hold the port to jax.grad at 1e-4 of it; phase 19 held the
#: forward's logits to 7.6e-6)
GRAD_REL_TOL = 1e-3
#: (b) one adamw_update of the same gradients, card vs CPU: the same
#: element-wise float32 ops (IEEE division and square root on both, and
#: count = 1 makes b ** count exact), so at most an ulp of the parameter
UPDATE_ULP_TOL = 2**-22
#: (c) float32 losses of 3 trainer steps, card (TF32 off) vs CPU: the
#: gradients agree to ~1e-6 of their scale and AdamW's first steps move
#: each element by ~lr whatever its size, so losses agree to ~1e-5; a
#: router near-tie that flips one token's expert in an MoE layer would
#: move the loss by ~1e-4 (one token of 512)
ARCH_LOSS_RTOL = 1e-3
#: (d) the replayed steps run the same ops on the same restored state;
#: only kernels that accumulate with atomics (index-add backwards of the
#: embedding lookup, in bf16) can differ run to run
REPLAY_RTOL = 1e-3


def train_cfg(steps, **kw):
    """Phase 20's ``TrainConfig``: peak lr 1e-3 after 5 warmup steps,
    no logging, ``kw`` overriding."""
    from repro_torch.train import TrainConfig

    return TrainConfig(**{"peak_lr": 1e-3, "warmup_steps": 5,
                          "total_steps": steps, "log_every": 10**9, **kw})


def record_steps(step_fn, times, metrics):
    """``step_fn`` that also records its seconds to a device sync and its
    metrics."""
    import torch

    def call(*a):
        t0 = time.perf_counter()
        out = step_fn(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(out[2])
        return out

    return call


def step_trace(trainer):
    """Device time, kernel launches and the five operators whose kernels
    took the most device time (name, ms, calls) in one train step, from
    a ``torch.profiler`` trace; None when the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(1, log=lambda *_: None)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        return None
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:5]
    return dev_us / 1e3, sum(e.count for e in kernels), [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in top]


def phase_train_qwen(dev):
    """Phase 20 (a): Qwen3-0.6B at full width and depth trained by
    ``Trainer`` over ``SyntheticLMStream``: bf16 params, f32 moments."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, make_train_step

    cfg = get_config(LM_ARCH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    opt = adamw_init(model)
    tcfg = train_cfg(TRAIN_STEPS)
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED))
    times, metrics = [], []
    tr = Trainer(cfg, tcfg, model, opt, stream, record_steps(
        make_train_step(cfg, tcfg), times, metrics))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    hist = tr.run(TRAIN_STEPS, log=lambda *_: None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(hist) == TRAIN_STEPS and np.isfinite(hist).all(),
          f"qwen losses not all finite: {hist}")
    check(all(m["bad_step"] == 0 for m in metrics), "a bad step")
    first, last = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    check(last < first, f"qwen loss did not fall: {first} -> {last}")
    t0 = time.perf_counter()
    stream.batch_at(0)
    data_s = time.perf_counter() - t0
    steady = times[2:]  # the first steps pay cuBLAS's and the allocator's
    p50, p99 = pct(steady, 50), pct(steady, 99)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gnorm = [float(m["grad_norm"]) for m in metrics]
    log(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} bf16 "
        f"parameters, f32 moments; {TRAIN_STEPS} steps at batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_SEQ // cfg.loss_chunk} loss "
        f"chunks), peak lr {tcfg.peak_lr} warmup {tcfg.warmup_steps}: loss "
        f"{hist[0]:.4f} -> {hist[-1]:.4f} (mean of the first 5 {first:.4f}, "
        f"last 5 {last:.4f}), grad norm {gnorm[0]:.3f} -> {gnorm[-1]:.3f}, "
        f"no bad step; {wall:.2f}s in all; step ms p50 {p50:.2f} p99 "
        f"{p99:.2f} (steps 2-{TRAIN_STEPS - 1}; first {times[0] * 1e3:.1f}),"
        f" {tokens / (p50 / 1e3):.1f} tokens/s at p50; the stream's batch "
        f"{data_s * 1e3:.1f} ms on the host; peak {peak:.2f} GiB "
        f"({held:.2f} GiB held before it)")
    out = {"wall_s": wall, "step_p50_ms": p50, "step_p99_ms": p99,
           "tokens_per_s": tokens / (p50 / 1e3), "peak_gib": peak,
           "first5": first, "last5": last}
    busy = step_trace(tr)
    if busy is None:
        log("  train step trace: the profiler saw no device time")
    else:
        dev_ms, n, top = busy
        log(f"  train step trace (torch.profiler, one step): {dev_ms:.3f} "
            f"ms of kernels and {n} kernel launches; against the p50 step "
            f"{p50:.2f} ms the card is busy {dev_ms / p50:.1%}; most device "
            f"time: " + "; ".join(f"{k} {ms:.3f} ms x {c}"
                                  for k, ms, c in top))
        out.update(step_kernel_ms=dev_ms, step_kernels=n)
    return tr.params, cfg, out


def grads_of(model, cfg, batch):
    from repro_torch.models import loss_fn

    loss, _ = loss_fn(model, cfg, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_train_grads(dev, model, cfg, rng):
    """Phase 20 (b): the float32 copy of the trained Qwen3-0.6B, one
    ``loss_fn`` and backward on the card (TF32 off) and on the CPU, then
    one ``adamw_update`` of the CPU's gradients on each."""
    import torch

    from repro_torch.optim import adamw_init, adamw_update

    seq = rng.integers(0, cfg.vocab_size, (GRAD_ROWS, LM_PROMPT + 1))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    cpu = torch.device("cpu")
    m32, cfg32 = f32_copy(model, cfg, dev)
    cpu32, _ = f32_copy(model, cfg, cpu)
    t0 = time.perf_counter()
    loss_card, g_card = grads_of(m32, cfg32, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads_of(cpu32, cfg32, batch)
    cpu_s = time.perf_counter() - t0
    worst, worst_leaf = -1.0, None
    for n, g in g_cpu.items():
        scale = float(g.abs().max())
        err = float((g_card[n].cpu() - g).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_leaf = err, n
    check(worst <= GRAD_REL_TOL,
          f"f32 gradients card vs CPU: {worst_leaf} {worst:.3g}")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
          f"f32 loss card {loss_card} vs CPU {loss_cpu}")
    del g_card
    # one AdamW step of the same (the CPU's) gradients on each device
    lr = 1e-3
    g_dev = {n: g.to(dev) for n, g in g_cpu.items()}
    t0 = time.perf_counter()
    adamw_update(m32, g_dev, adamw_init(m32), lr)
    torch.cuda.synchronize()
    upd_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    adamw_update(cpu32, g_cpu, adamw_init(cpu32), lr)
    upd_cpu_s = time.perf_counter() - t0
    upd_worst, bitwise = 0.0, True
    for pc, pk in zip(cpu32.parameters(), m32.parameters()):
        pc, pk = pc.detach(), pk.detach().cpu()
        d = float((pk - pc).abs().max())
        bitwise &= d == 0.0
        upd_worst = max(upd_worst, d / max(float(pc.abs().max()), 1e-30))
    check(upd_worst <= UPDATE_ULP_TOL,
          f"adamw_update card vs CPU: {upd_worst:.3g} of max |p|")
    log(f"  float32 copy, loss_fn + backward on {GRAD_ROWS} x {LM_PROMPT}: "
        f"loss card {loss_card:.6f} CPU {loss_cpu:.6f}; max |grad diff| / "
        f"leaf max |g| {worst:.3g} ({worst_leaf}; <= {GRAD_REL_TOL}); card "
        f"{card_s:.3f}s, CPU {cpu_s:.3f}s; one adamw_update of the same "
        f"gradients: max |param diff| {upd_worst:.3g} of max |p| (<= "
        f"{UPDATE_ULP_TOL:.3g}), {'bitwise' if bitwise else 'not bitwise'}; "
        f"card {upd_card_s:.3f}s, CPU {upd_cpu_s:.3f}s")
    return {"grad_rel": worst, "update_rel": upd_worst,
            "update_bitwise": bitwise, "card_s": card_s, "cpu_s": cpu_s}


def phase_train_archs(dev):
    """Phase 20 (c): the nine other architectures at ``launch.train``'s
    ``small`` preset: 3 trainer steps in float32 on the card and on the
    CPU from the same weights, then one bf16 step on the card."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import build
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, make_train_step

    out = {}
    for name in sorted(ARCHS):
        if name == LM_ARCH:
            continue
        t0 = time.perf_counter()
        cfg = build("small", name)
        tcfg = train_cfg(ARCH_STEPS, peak_lr=3e-3, warmup_steps=1)
        stream = SyntheticLMStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=ARCH_SEQ,
            global_batch=ARCH_BATCH, seed=SEED))
        cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu")
        card_model = copy.deepcopy(cpu_model).to(dev)
        hists, secs = {}, {}
        for where, model in (("card", card_model), ("cpu", cpu_model)):
            s0 = time.perf_counter()
            tr = Trainer(cfg, tcfg, model, adamw_init(model), stream,
                         make_train_step(cfg, tcfg))
            hists[where] = tr.run(ARCH_STEPS, log=lambda *_: None)
            if where == "card":
                torch.cuda.synchronize()
            secs[where] = time.perf_counter() - s0
        card, cpu = np.asarray(hists["card"]), np.asarray(hists["cpu"])
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        check(np.isfinite(card).all() and rel <= ARCH_LOSS_RTOL,
              f"{name}: f32 losses card {card} vs CPU {cpu}")
        del card_model, cpu_model
        bf = dataclasses.replace(cfg, param_dtype="bfloat16",
                                 compute_dtype="bfloat16")
        model = init_params(bf, torch.Generator(device=dev).manual_seed(SEED),
                            dev)
        tr = Trainer(bf, tcfg, model, adamw_init(model), stream,
                     make_train_step(bf, tcfg))
        bf_loss = tr.run(1, log=lambda *_: None)[0]
        check(math.isfinite(bf_loss), f"{name}: bf16 step loss {bf_loss}")
        wall = time.perf_counter() - t0
        n = sum(p.numel() for p in model.parameters())
        log(f"  {name}: small preset ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, {n} parameters), "
            f"{ARCH_STEPS} f32 steps at {ARCH_BATCH} x {ARCH_SEQ}: losses "
            f"card {np.array2string(card, precision=6)} vs CPU max rel diff "
            f"{rel:.3g} (<= {ARCH_LOSS_RTOL}); card {secs['card']:.2f}s, CPU "
            f"{secs['cpu']:.2f}s; bf16 step loss {bf_loss:.4f}; {wall:.2f}s")
        out[name] = {"rel": rel, "bf16_loss": bf_loss, "wall_s": wall}
        del model, tr
        torch.cuda.empty_cache()
    return out


def phase_train_restart(dev):
    """Phase 20 (d): SmolLM-135M whole, bf16: a checkpoint at step
    CKPT_AT of a CKPT_STEPS-step run, restored into a fresh ``Trainer``
    that replays the last steps."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, make_train_step

    cfg = get_config("smollm-135m")
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        tcfg = train_cfg(CKPT_STEPS, checkpoint_every=CKPT_AT,
                         checkpoint_dir=ck)

        def trainer(seed):
            model = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed), dev)
            return Trainer(cfg, tcfg, model, adamw_init(model), stream,
                           make_train_step(cfg, tcfg))

        tr = trainer(SEED)
        t0 = time.perf_counter()
        tr.run(CKPT_AT, log=lambda *_: None)  # saves step CKPT_AT
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        saved = {n: p.detach().cpu().clone()
                 for n, p in tr.params.named_parameters()}
        moments = {k: {n: t.cpu().clone() for n, t in tr.opt_state[k].items()}
                   for k in ("mu", "nu")}
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(ck) for f in fs)
        tr.run(CKPT_STEPS - CKPT_AT, log=lambda *_: None)
        want = tr.history[CKPT_AT:]
        del tr
        tr2 = trainer(SEED + 1)
        t0 = time.perf_counter()
        check(tr2.maybe_restore() and tr2.step == CKPT_AT,
              "restore from the checkpoint")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for n, p in tr2.params.named_parameters():
            check(p.dtype == torch.bfloat16 and p.is_cuda
                  and torch.equal(p.detach().cpu(), saved[n]),
                  f"restored {n}")
        for k in ("mu", "nu"):
            for n, t in tr2.opt_state[k].items():
                check(torch.equal(t.cpu(), moments[k][n]), f"restored {k} {n}")
        check(int(tr2.opt_state["count"]) == CKPT_AT, "restored count")
        got = tr2.run(CKPT_STEPS - CKPT_AT, log=lambda *_: None)
    rel = float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))
    check(rel <= REPLAY_RTOL, f"replayed losses {got} vs {want}")
    log(f"  {cfg.name} whole, bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"{CKPT_AT} steps in {run_s:.2f}s with a checkpoint at step "
        f"{CKPT_AT} ({size / 2**30:.3f} GiB on disk, written to a temporary "
        f"directory and removed); a fresh Trainer restored it in "
        f"{restore_s:.2f}s: parameters, moments and count bitwise equal to "
        f"those saved; steps {CKPT_AT}-{CKPT_STEPS - 1} replayed: losses "
        f"{got} vs {want}, "
        + ("bitwise" if got == want else f"max rel diff {rel:.3g} (<= "
           f"{REPLAY_RTOL})"))
    return {"replay_rel": rel, "bitwise": got == want, "ckpt_gib":
            size / 2**30, "restore_s": restore_s}


def phase_train_knnlm(dev, tally):
    """Phase 20 (e): ``repro_torch.examples.knnlm_serve.main`` on the
    card: 60 training steps, a datastore of 20 batches' hidden states and
    the perplexities; its retrieval held against a direct query."""
    from repro_torch.core import knnlm
    from repro_torch.examples import knnlm_serve

    seen = []
    build = knnlm.build_datastore

    def build_and_watch(*a, **kw):
        store = build(*a, **kw)
        query = store.index.query

        def keep(*qa, **qkw):
            res = query(*qa, **qkw)
            seen.append((store, qa, qkw, res))
            return res

        store.index.query = keep
        return store

    knnlm.build_datastore = build_and_watch
    try:
        res, wall, counts = counted(
            "knnlm_serve", lambda: knnlm_serve.main(["--device", "cuda"]),
            tally, need=("pairwise_topk", "grid_round"))
    finally:
        knnlm.build_datastore = build
    check(len(seen) == 1, f"{len(seen)} retrievals")
    store, qa, qkw, retrieval = seen[0]
    del store.index.query
    direct = store.index.query(*qa, **qkw)
    check(np.array_equal(retrieval.dists, direct.dists)
          and np.array_equal(retrieval.idxs, direct.idxs),
          "knnlm_serve retrieval vs a direct query")
    check(res["knn"][0.25] < res["lm"],
          f"kNN-LM {res['knn'][0.25]} not below LM-only {res['lm']}")
    log(f"  knnlm_serve on the card: loss {res['loss']:.4f} after 60 steps; "
        f"{len(store.targets)} entries; perplexity LM-only {res['lm']:.4f}, "
        f"kNN-LM " + ", ".join(f"lam {k} {v:.4f}"
                               for k, v in res["knn"].items())
        + f"; {wall:.2f}s, launches {counts}; retrieval bitwise equal to a "
        f"direct query")
    return {"wall_s": wall, "lm": res["lm"], "knn": res["knn"]}


def phase_train(dev, tally):
    """Phase 20: training on the card (see the module docstring)."""
    import torch

    rng = np.random.default_rng(SEED)
    out, secs = {}, {}
    t0 = time.perf_counter()
    model, cfg, out["qwen"] = phase_train_qwen(dev)
    secs["qwen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["grads"] = phase_train_grads(dev, model, cfg, rng)
    secs["grads"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["archs"] = phase_train_archs(dev)
    secs["archs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["restart"] = phase_train_restart(dev)
    secs["restart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["knnlm"] = phase_train_knnlm(dev, tally)
    secs["knnlm"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


# -- phase 21: parallelism and the dry-run -----------------------------------


SHARD_STEPS = 5  # phase 21 (a): sharded Qwen3-0.6B steps at 8 x 1024
#: (a) the sharded run's first step: the end of train_cfg's warmup, so
#: its update is a real one at the peak lr
SHARD_START = 5
#: (a) bf16, sharded (two data rows of 4 x 1024) vs one device (8 x
#: 1024), the first two losses: before any update and after one real
#: update.  The same per-token math, products of other batch sizes
#: (cuBLAS may pick other kernels, so other bf16 roundings), the rows'
#: losses weighted by their token counts; AdamW's first update from zero
#: moments is lr x sign(g), so only elements whose gradient sign the
#: roundings flip move apart.  A step that lost a row's gradient would
#: move the second loss by far more.
SHARD_BF16_LOSS_RTOL = 1e-3
#: (a) float32, sharded vs one device, one step from one state, repeated
#: from SHARD_F32_READINGS states: loss and gradient norm rtol 1e-5,
#: parameters rtol 1e-5 above a floor of SHARD_F32_LR_FLOOR x lr.  AdamW
#: divides each gradient element by its running RMS, so where an
#: element's moment and gradient are both near zero the rows' float32
#: rounding moves its update.  From this phase's three states an H100
#: read 2.87e-3, 8.8e-4 and 2.8e-4 lr (repeat runs read the same; the
#: CPU's smoke model, tests/test_torch_parallel.py: 7e-4 lr), so the
#: floor is 1.7x the highest reading.  Then one more step each way from
#: its own state: the loss after a real sharded update, rtol 1e-5.
SHARD_F32_RTOL = 1e-5
SHARD_F32_LR_FLOOR = 5e-3
SHARD_F32_READINGS = 3
N_STAGES, N_MICRO = 4, 4  # phase 21 (b): 28 layers in 4 stages of 7
CMEAN_ROWS = 4  # phase 21 (c): data positions of the compressed mean
CMEAN_REL_TOL = 0.05  # tests/test_distributed.py's bound on its error
KNN_ROWS = 4096  # phase 21 (d): rows held against the brute backend
#: phase 21 (d): the grid engine's points a shard, cut from the cell's
#: 2^20: its 16 host grid probes of 2^20 points took 29-51 s a mesh in
#: two runs, most of phase 21's 100-124 s, and 12-13 s a mesh at 2^19;
#: cut to keep the whole script inside two thirds of its time limit
GRID_CELL_POINTS = 1 << 18


def cosine_lr(tcfg, step):
    from repro_torch.optim import cosine_schedule

    return cosine_schedule(step, peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)


def sharded_setup(cfg, named, opt, mesh, batch):
    """Shardings and a sharded step of ``named`` / ``opt`` on ``mesh``."""
    from repro_torch.parallel import (batch_shardings, param_shardings,
                                      shard_tree)
    from repro_torch.train.trainer import make_sharded_train_step

    p_sh = param_shardings(named, cfg, mesh)
    o_sh = param_shardings(opt, cfg, mesh, role="opt")
    b_sh = batch_shardings(batch, cfg, mesh)
    step = make_sharded_train_step(cfg, train_cfg(SHARD_STEPS + 10), mesh,
                                   p_sh, o_sh, b_sh)
    return (p_sh, o_sh, b_sh), step, shard_tree(named, p_sh), shard_tree(
        opt, o_sh)


def phase_shard_qwen(dev):
    """Phase 21 (a): Qwen3-0.6B at full width and depth on a (2, 2)
    ("data", "model") mesh of the card: 5 sharded steps at 8 x 1024 from
    the end of the warmup, the first two losses (before and after one
    real update) against the one-device step's, then the float32 copy on
    2 x 128: one step from one state both ways, from three states, and a
    step after a real sharded update."""
    import torch

    from repro_torch import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch import analysis
    from repro_torch.models import LM, init_params
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import gather_tree
    from repro_torch.train import make_train_step

    cfg = get_config(LM_ARCH)
    mesh = DeviceMesh([[dev] * 2] * 2, ("data", "model"))
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch_at(s).items()}
               for s in range(SHARD_STEPS)]
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    named = {k: v.detach() for k, v in model.named_parameters()}
    opt = adamw_init(model)
    shs, step, params, state = sharded_setup(cfg, named, opt, mesh,
                                             batches[0])
    shard_gib = sum(t.numel() * t.element_size()
                    for t in params[(0, 0)].values()) / 2**30
    moment_gib = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                     for t in state[(0, 0)][k].values()) / 2**30
    # the one-device step on the same weights and batches: the loss
    # before any update, then after one real update
    one = make_train_step(cfg, train_cfg(SHARD_STEPS + 10))
    want = []
    for s in range(2):
        model, opt, m1 = one(model, opt, SHARD_START + s, batches[s])
        want.append(m1["loss"])
    del model, opt, named, m1
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s, b in enumerate(batches):
        t0 = time.perf_counter()
        params, state, m = step(params, state, SHARD_START + s, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        check(m["bad_step"] == 0, f"sharded step {s} was bad")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(np.isfinite(losses).all(), f"sharded losses {losses}")
    gaps = [abs(g - w) / abs(w) for g, w in zip(losses, want)]
    check(max(gaps) <= SHARD_BF16_LOSS_RTOL,
          f"sharded losses {losses[:2]} vs one device {want}")
    got = analysis.collective_bytes(m["collectives"])
    want_log = analysis.collective_bytes(analysis.step_collectives(
        *shs, "train"))
    check(got == want_log, f"collective log {got} != closed form {want_log}")
    p50 = pct(times[1:], 50)
    log(f"  bf16 on {mesh}: {SHARD_STEPS} steps at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} (2 data rows of {TRAIN_BATCH // 2}) from step "
        f"{SHARD_START} (peak lr): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; the first two vs one "
        f"device {want[0]:.6f}, {want[1]:.6f} (before and after one "
        f"update): relative gaps {gaps[0]:.3g}, {gaps[1]:.3g} (<= "
        f"{SHARD_BF16_LOSS_RTOL}); step ms p50 {p50:.2f} (steps 1-"
        f"{SHARD_STEPS - 1}; first {times[0] * 1e3:.1f}); a position holds "
        f"{shard_gib:.4f} GiB of bf16 parameter slices and {moment_gib:.4f}"
        f" GiB of f32 moments; peak {peak:.2f} GiB; collectives a step "
        f"{json.dumps(got['bytes'])} ({got['total_bytes']} B, the log "
        f"equal to step_collectives)")
    out = {"losses": losses, "first_gaps": gaps, "step_p50_ms": p50,
           "shard_gib": shard_gib, "moment_gib": moment_gib,
           "peak_gib": peak, "collective_bytes": got["total_bytes"]}
    full = gather_tree(params, shs[0])
    del params, state

    # float32 copy on 2 x 128: one warm step on one device, then from each
    # of SHARD_F32_READINGS states one step on one device and sharded
    rng = np.random.default_rng(SEED)
    seq = rng.integers(0, cfg.vocab_size, (GRAD_ROWS, LM_PROMPT + 1))
    b32 = {"tokens": torch.as_tensor(seq[:, :-1], device=dev),
           "labels": torch.as_tensor(seq[:, 1:], device=dev)}
    src = LM(cfg, "meta").to_empty(device=dev)
    with torch.no_grad():
        for k, p in src.named_parameters():
            p.copy_(full[k])
    del full
    m32, cfg32 = f32_copy(src, cfg, dev)
    del src
    tcfg = train_cfg(SHARD_STEPS + 10)
    one = make_train_step(cfg32, tcfg)
    opt32 = adamw_init(m32)
    m32, opt32, _ = one(m32, opt32, 5, b32)
    readings, loss_rels, norm_rels, beyond, total = [], [], [], 0, 0
    for r in range(SHARD_F32_READINGS):
        s = 6 + r
        named32 = {k: v.detach().clone() for k, v in m32.named_parameters()}
        opt_copy = {"mu": {k: v.clone() for k, v in opt32["mu"].items()},
                    "nu": {k: v.clone() for k, v in opt32["nu"].items()},
                    "count": opt32["count"].clone()}
        shs32, step32, p32, o32 = sharded_setup(cfg32, named32, opt_copy,
                                                mesh, b32)
        del named32, opt_copy
        m32, opt32, r1 = one(m32, opt32, s, b32)
        p32, o32, r2 = step32(p32, o32, s, b32)
        loss_rels.append(abs(r2["loss"] - r1["loss"]) / abs(r1["loss"]))
        norm_rels.append(float((r2["grad_norm"] - r1["grad_norm"]).abs()
                               / r1["grad_norm"]))
        lr = float(cosine_lr(tcfg, s))
        got32 = gather_tree(p32, shs32[0])
        worst = 0.0
        for k, p in m32.named_parameters():
            d = (got32[k] - p.detach()).abs()
            worst = max(worst, float(d.max()))
            if r == 0:
                beyond += int((d > SHARD_F32_RTOL * p.detach().abs()).sum())
                total += p.numel()
            fail = ~(d <= SHARD_F32_RTOL * p.detach().abs()
                     + SHARD_F32_LR_FLOOR * lr)
            check(not bool(fail.any()),
                  f"f32 sharded params {k} from state {r}: max |diff| "
                  f"{float(d.max()):.3g} ({float(d.max()) / lr:.3g} lr); "
                  f"readings so far {readings}")
        readings.append(worst / lr)
        del got32
    # one more step each way, each from its own state: the loss after the
    # sharded step's own update
    s = 6 + SHARD_F32_READINGS
    _, _, r1 = one(m32, opt32, s, b32)
    _, _, r2 = step32(p32, o32, s, b32)
    after_rel = abs(r2["loss"] - r1["loss"]) / abs(r1["loss"])
    check(max(loss_rels + norm_rels + [after_rel]) <= SHARD_F32_RTOL,
          f"f32 sharded vs one device: loss {loss_rels}, grad norm "
          f"{norm_rels}, loss after its own update {after_rel}")
    log(f"  float32 copy on {GRAD_ROWS} x {LM_PROMPT}, one step from one "
        f"state (after a warm one-device step), from "
        f"{SHARD_F32_READINGS} states: loss relative "
        f"{', '.join(f'{x:.3g}' for x in loss_rels)}, grad norm relative "
        f"{', '.join(f'{x:.3g}' for x in norm_rels)} (<= {SHARD_F32_RTOL}); "
        f"parameters max |diff| "
        f"{', '.join(f'{x:.3g}' for x in readings)} lr (floor "
        f"{SHARD_F32_LR_FLOOR} lr), state 0: {beyond} of {total} beyond "
        f"rtol {SHARD_F32_RTOL} alone; the loss after a sharded update vs "
        f"one device's: relative {after_rel:.3g} (<= {SHARD_F32_RTOL})")
    out.update(f32_loss_rel=loss_rels, f32_norm_rel=norm_rels,
               f32_param_lr=readings, f32_beyond_rtol=beyond,
               f32_after_rel=after_rel)
    return out


def phase_pipeline(dev, cfg, model, batch):
    """Phase 21 (b): Qwen3-0.6B's 28 layers as 4 stages of 7 on a
    4-position ("stage",) mesh, 4 microbatches of the 8 x 1024 batch's
    embeddings, bitwise against the layers applied in order."""
    import torch

    from repro_torch import DeviceMesh
    from repro_torch.models.model import _embed, _rope
    from repro_torch.models.transformer import apply_layer
    from repro_torch.parallel import pipeline_apply

    per = cfg.n_layers // N_STAGES
    with torch.no_grad():
        x = _embed(model, cfg, batch["tokens"])
        cos, sin = _rope(cfg, torch.arange(x.shape[1], device=dev))
        kinds = cfg.layer_kinds

        def stage_fn(ids, h):
            for i in ids:
                h, _ = apply_layer(model.layers[i], h, cos, sin, cfg,
                                   kinds[i])
            return h

        stages = [list(range(s * per, (s + 1) * per))
                  for s in range(N_STAGES)]
        xs = x.reshape(N_MICRO, x.shape[0] // N_MICRO, *x.shape[1:])
        fn = pipeline_apply(DeviceMesh([dev] * N_STAGES, ("stage",)),
                            stage_fn, N_MICRO)
        pipe_ms = median_ms(lambda: fn(stages, xs), 3,
                            torch.cuda.synchronize)
        got = fn(stages, xs)
        want = torch.stack([stage_fn(range(cfg.n_layers), xs[m])
                            for m in range(N_MICRO)])
        seq_ms = median_ms(lambda: [stage_fn(range(cfg.n_layers), xs[m])
                                    for m in range(N_MICRO)], 3,
                           torch.cuda.synchronize)
    check(torch.equal(got, want), "pipeline output differs from the layers "
          "applied in order")
    sch = fn.schedule
    log(f"  {N_STAGES} stages x {per} layers, {N_MICRO} microbatches of "
        f"{tuple(xs.shape[1:])}: {sch['ticks']} ticks, {sch['busy']} busy "
        f"and {sch['bubbles']} bubble stage-ticks (utilization "
        f"{N_MICRO / sch['ticks']:.3f} per stage); bitwise equal to the "
        f"layers applied in order; {pipe_ms:.2f} ms (sequential "
        f"{seq_ms:.2f} ms; one card runs every stage, so no overlap)")
    return {"ticks": sch["ticks"], "bubbles": sch["bubbles"],
            "pipe_ms": pipe_ms, "seq_ms": seq_ms}


def phase_cmean(dev, cfg, model, batch):
    """Phase 21 (c): ``compressed_psum_mean`` over 4 data positions of the
    card on 4 rows' gradients (each 2 x 1024 of (a)'s batch; the leaves of
    layer 0 and the final norm), bitwise against the same formula on the
    CPU, and its error against the exact mean."""
    import torch

    from repro_torch import DeviceMesh
    from repro_torch.launch import analysis
    from repro_torch.models import loss_fn
    from repro_torch.parallel import tree_compressed_psum_mean

    keep = [k for k, _ in model.named_parameters()
            if k.startswith("layers.0.") or k == "final_norm"]
    rows = TRAIN_BATCH // CMEAN_ROWS
    trees = {}
    for r in range(CMEAN_ROWS):
        part = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        loss, _ = loss_fn(model, cfg, part)
        loss.backward()
        grads = dict(model.named_parameters())
        trees[(r,)] = {k: grads[k].grad.float() for k in keep}
        model.zero_grad(set_to_none=True)
    log_ = []
    t0 = time.perf_counter()
    got = tree_compressed_psum_mean(
        trees, DeviceMesh([dev] * CMEAN_ROWS, ("data",)), "data", log=log_)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = tree_compressed_psum_mean(
        {p: {k: v.cpu() for k, v in t.items()} for p, t in trees.items()},
        DeviceMesh(["cpu"] * CMEAN_ROWS, ("data",)), "data")
    worst = 0.0
    for k in keep:
        for p in trees:
            check(torch.equal(got[p][k].cpu(), cpu[p][k]),
                  f"compressed mean {k} at {p}: card differs from the CPU")
        exact = torch.stack([trees[p][k] for p in trees]).mean(0)
        err = float((got[(0,)][k] - exact).abs().max()) / max(
            float(exact.abs().max()), 1e-30)
        worst = max(worst, err)
    check(worst < CMEAN_REL_TOL, f"compressed mean error {worst}")
    n = sum(trees[(0,)][k].numel() for k in keep)
    sent = analysis.collective_bytes(log_)["total_bytes"]
    log(f"  {len(keep)} leaves ({n} values) over {CMEAN_ROWS} positions: "
        f"bitwise equal to the CPU's; max |mean - exact| / max |exact| "
        f"{worst:.4g} (< {CMEAN_REL_TOL}); {card_s:.3f} s; logged "
        f"{sent} B of all-reduce a position (int32 sums; int8 values)")
    return {"rel_err": worst, "card_s": card_s}


def phase_knn_cell(dev, tally):
    """Phase 21 (d): the dry-run's trueknn cell on the card, dense and grid
    engines on 256 and 512 positions, 4096 sampled rows against the brute
    backend, and one position's ``pairwise_topk`` call against its plain
    version."""
    import torch

    import dataclasses

    from repro_torch import KnnSpec, build_index
    from repro_torch.configs.trueknn import CONFIG
    from repro_torch.kernels.ops import topk_engine
    from repro_torch.kernels.ref import pairwise_topk_ref
    from repro_torch.launch import dryrun

    out, err = {}, 0.0
    rng = np.random.default_rng(SEED)
    grid_cfg = dataclasses.replace(CONFIG, n_points=GRID_CELL_POINTS)
    log(f"  (the grid engine's cell cut to {GRID_CELL_POINTS} points a shard "
        f"from {CONFIG.n_points}: its host grid probes)")
    for engine, need, kcfg in (("dense", "pairwise_topk", CONFIG),
                               ("grid", "grid_round", grid_cfg)):
        for multi in (False, True):
            (rec, pts, qs, ans), wall, counts = counted(
                f"trueknn cell {engine}",
                lambda: dryrun.lower_trueknn_cell(multi, engine, device=dev,
                                                kcfg=kcfg),
                tally, need=(need,))
            check(rec["launches"][need] == rec["n_chips"],
                  f"{engine}: {rec['launches']} launches on "
                  f"{rec['n_chips']} positions")
            rows = np.sort(rng.choice(qs.shape[0], KNN_ROWS, replace=False))
            d2, idx, cnt = (t.cpu().numpy() for t in ans)
            dist = np.sqrt(np.maximum(d2[rows], 0))
            pts_t = torch.as_tensor(pts, device=dev)
            q_t = torch.as_tensor(qs[rows], device=dev)
            if engine == "dense":
                want = build_index(pts, backend="brute", device=dev).query(
                    qs[rows], KnnSpec(8))
                same = (np.array_equal(dist, want.dists)
                        and np.array_equal(idx[rows], want.idxs))
                check(same, f"dense cell on {rec['n_chips']} vs brute")
                extra = "distances and indices bitwise equal to brute's"
            else:
                r2 = float(np.float32(rec["radius"]) ** 2)
                qid = torch.full((KNN_ROWS,), -1, dtype=torch.int32,
                                 device=dev)
                bd, bi, bc = (t.cpu().numpy() for t in topk_engine(
                    q_t, qid, pts_t, r2, k=8))
                check(np.array_equal(cnt[rows], bc),
                      f"grid cell on {rec['n_chips']}: found != ball counts")
                m = np.minimum(cnt[rows], 8)
                cols = np.arange(8)[None, :] < m[:, None]
                check(np.array_equal(d2[rows][cols], bd[cols]),
                      f"grid cell on {rec['n_chips']}: in-radius distances")
                gi = np.where(cols, idx[rows], -1)
                wi = np.where(cols, bi, -1)
                check(np.array_equal(np.sort(gi, 1), np.sort(wi, 1)),
                      f"grid cell on {rec['n_chips']}: in-radius indices")
                extra = (f"radius {rec['radius']:.6g} (table {rec['table']}, "
                         f"cap {rec['cap']}), {float((cnt >= 8).mean()):.3f}"
                         f" of rows resolved; found and the in-radius "
                         f"distances bitwise equal to brute's, indices up "
                         f"to order")
            log(f"  {engine} on {rec['n_chips']} positions ({rec['cell']}): "
                f"setup {rec['setup_s']:.3f} s, first call "
                f"{rec['first_s']:.3f} s, warm {rec['warm_s']:.3f} s, "
                f"launches {rec['launches']}; {KNN_ROWS} rows: {extra}")
            out[f"{engine}_{rec['n_chips']}"] = {
                k: rec[k] for k in ("setup_s", "first_s", "warm_s")}
            if engine == "dense" and not multi:
                # position (0, 15)'s call: query slice 0, shard 15
                nl = pts.shape[0] // 16
                q_l = torch.as_tensor(qs[:qs.shape[0] // 16], device=dev)
                p_l = pts_t[15 * nl:16 * nl].contiguous()
                qid_l = torch.full((q_l.shape[0],), -1 - 15 * nl,
                                   dtype=torch.int32, device=dev)
                got = topk_engine(q_l, qid_l, p_l, math.inf, k=8)
                ref = pairwise_topk_ref(q_l, p_l, 8, radius2=math.inf,
                                        query_ids=qid_l)
                err = compare_topk("position (0, 15)", got, ref, q_l, p_l,
                                   "l2", True)
                log(f"  position (0, 15)'s pairwise_topk call (Q="
                    f"{q_l.shape[0]} N={nl} k=8) bitwise equal to the plain "
                    f"version")
            del pts_t, ans
            torch.cuda.empty_cache()
    return out, err


def phase_dryrun_cli():
    """Phase 21 (e): ``launch.dryrun.main`` in process on meta for two
    cells."""
    import tempfile

    from repro_torch.launch import dryrun

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        for arch, cell, mesh in (("qwen3-0.6b", "train_4k", "single"),
                                 ("deepseek-v2-lite-16b", "decode_32k",
                                  "multi")):
            t0 = time.perf_counter()
            (rec,) = dryrun.main(["--arch", arch, "--cell", cell, "--mesh",
                                  mesh, "--out", d])
            check(rec["status"] == "ok", f"dry-run {arch} {cell}: {rec}")
            r = rec["roofline"]
            coll = (f"{r['collective_s']:.4g} s" if rec["collectives"]
                    else f"none ({rec['collectives_note']})")
            log(f"  {arch} {cell} {mesh}: {rec['n_chips']} positions, "
                f"{rec['memory']['argument_size_in_bytes'] / 2**30:.4f} GiB "
                f"of arguments a position, {rec['cost_flops']:.4g} product "
                f"FLOP a position, roofline compute {r['compute_s']:.4g} s "
                f"memory {r['memory_s']:.4g} s collective {coll} "
                f"({r['dominant']}; analytic on H100 constants); "
                f"{time.perf_counter() - t0:.2f} s")
            out[f"{arch}/{cell}/{mesh}"] = r["dominant"]
    return out


def phase_parallel(dev, tally):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import init_params

    secs, out = {}, {}
    t0 = time.perf_counter()
    out["sharded"] = phase_shard_qwen(dev)
    secs["sharded"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLMStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH, seed=SEED)).batch_at(0).items()}
    t0 = time.perf_counter()
    out["pipeline"] = phase_pipeline(dev, cfg, model, batch)
    secs["pipeline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cmean"] = phase_cmean(dev, cfg, model, batch)
    secs["cmean"] = time.perf_counter() - t0
    del model, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["knn"], out["topk_err"] = phase_knn_cell(dev, tally)
    secs["knn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = phase_dryrun_cli()
    secs["dryrun"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


# -- phase 22: the deprecated entry forms -----------------------------------


def round_keys(res):
    """Each round's (radius, rows, resolved, tests) of a trueknn answer."""
    return [(r.radius, r.n_queries, r.n_resolved, r.n_tests)
            for r in res.rounds]


#: each deprecated form's message, as the reference words it
LEGACY_FORMS = {
    "trueknn()": "trueknn() is deprecated",
    "brute_knn()": "brute_knn() is deprecated",
    "fixed_radius_knn()": "fixed_radius_knn() is deprecated",
    "query(q, k)": "NeighborIndex.query(queries, k, radius=..., stop_radius"
                   "=...) is deprecated",
}


def phase_legacy(dev, kitti_np, index, b1, b1_wall, range5, radius, h1,
                 tally):
    """Phase 22: the reference's deprecated entry forms on kitti 2^20,
    each through the kernels of the path it adapts to and held bitwise
    against the spec form on the same data: ``trueknn()`` against phase
    4's batch 1 (both a fresh index with the same defaults and seed),
    ``brute_knn`` on phase 5's rows, ``fixed_radius_knn`` at phase 9's
    radius on those rows (against a fresh ``HybridSpec`` index) and as a
    self-query (against phase 9's first, fresh-grid batch), and
    ``index.query(q, k)`` / ``query(q, k=, radius=)`` on phase 4's warm
    index; each form warns once, from this file."""
    import warnings

    from repro_torch import HybridSpec, KnnSpec, build_index
    from repro_torch.api import query as query_mod
    from repro_torch.core import brute_knn, fixed_radius_knn, trueknn

    check(not query_mod._WARNED, "an earlier phase reached a deprecated "
          f"form: {sorted(query_mod._WARNED)}")
    rows, _ = range5
    q = kitti_np[rows]
    launched = {name: 0 for name in tally}

    def run(tag, fn, need):
        out, wall, counts = counted(tag, fn, tally, need=need)
        for name, c in counts.items():
            launched[name] += c
        return out, wall, counts

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, wall, counts = run("trueknn()", lambda: trueknn(
            kitti_np, 8, device=dev), ("grid_round", "pairwise_topk"))
        same_arrays("trueknn() vs phase 4's batch 1", res, b1,
                    ("dists", "idxs", "found", "n_tests"))
        check(round_keys(res) == round_keys(b1),
              "trueknn() rounds (radius, rows, resolved, tests) vs batch 1")
        log(f"  trueknn(kitti, 8): {res.n_rounds} rounds, n_tests="
            f"{res.n_tests}, dists/idxs/found/n_tests and every round's "
            f"radius, rows, resolved and tests bitwise equal to phase 4's "
            f"batch 1; wall_s={wall:.4f} (batch 1 wall_s={b1_wall:.4f}), "
            f"launches {counts}")

        (d, i, t), wall, counts = run(
            "brute_knn()",
            lambda: brute_knn(kitti_np, 8, queries=q, device=dev),
            ("pairwise_topk",))
        want = build_index(kitti_np, backend="brute", device=dev).query(
            q, KnnSpec(8))
        check(np.array_equal(d, want.dists) and np.array_equal(i, want.idxs)
              and t == want.n_tests, "brute_knn() vs the brute backend")
        log(f"  brute_knn on phase 5's {len(rows)} rows: dists, idxs and "
            f"n_tests={t} bitwise equal to build_index(backend='brute')"
            f".query(KnnSpec(8)); wall_s={wall:.4f}, launches {counts}")

        (d, i, f, t), wall, counts = run(
            "fixed_radius_knn()",
            lambda: fixed_radius_knn(kitti_np, radius, 8, queries=q,
                                     device=dev),
            ("grid_round",))
        want = build_index(kitti_np, backend="fixed_radius",
                           device=dev).query(q, HybridSpec(8, radius))
        check(np.array_equal(d, want.dists) and np.array_equal(i, want.idxs)
              and np.array_equal(f, want.found) and t == want.n_tests,
              "fixed_radius_knn() vs a fresh HybridSpec index")
        (d, i, f, t), wall_self, _ = run(
            "fixed_radius_knn() self-query",
            lambda: fixed_radius_knn(kitti_np, radius, 8, device=dev),
            ("grid_round",))
        check(np.array_equal(d, h1.dists) and np.array_equal(i, h1.idxs)
              and np.array_equal(f, h1.found) and t == h1.n_tests,
              "fixed_radius_knn() self-query vs phase 9's first batch")
        log(f"  fixed_radius_knn(r={radius:.6g}, 8) on those rows: "
            f"dists, idxs, found, n_tests bitwise equal to a fresh "
            f"HybridSpec(8, r) (wall_s={wall:.4f}, launches {counts}); as a "
            f"self-query equal to phase 9's first batch (n_tests={t}, "
            f"wall_s={wall_self:.4f})")

        r0 = b1.start_radius
        for tag, legacy, spec in (
                ("query(q, 8)", lambda: index.query(q, 8), KnnSpec(8)),
                (f"query(q, k=8, radius={r0:.6g})",
                 lambda: index.query(q, k=8, radius=r0),
                 KnnSpec(8, start_radius=r0))):
            got, wall, counts = run(tag, legacy, ("grid_round",))
            want = index.query(q, spec)
            same_arrays(f"{tag} vs {spec}", got, want, ("dists", "idxs"))
            log(f"  {tag} on phase 4's warm index: dists and idxs bitwise "
                f"equal to {spec} (start radii {got.start_radius:.6g} / "
                f"{want.start_radius:.6g}, rounds {got.n_rounds} / "
                f"{want.n_rounds}); wall_s={wall:.4f}, launches {counts}")

    dep = [x for x in caught if issubclass(x.category, DeprecationWarning)]
    for form, text in LEGACY_FORMS.items():
        n = sum(text in str(x.message) for x in dep)
        check(n == 1, f"{form} warned {n} times in the phase, not once")
    check(len(dep) == len(LEGACY_FORMS),
          f"{len(dep)} deprecation warnings, not {len(LEGACY_FORMS)}")
    here = os.path.abspath(__file__)
    check(all(os.path.abspath(x.filename) == here for x in dep),
          "a deprecation warning is attributed to another file than the "
          f"caller's: {sorted({x.filename for x in dep})}")
    for name in ("grid_round", "pairwise_topk"):
        check(launched[name] > 0, f"phase 22 never launched {name}")
    log(f"  each form warned once, from chip_smoke.py; phase launches "
        f"{launched}")


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
    # bf16 products accumulate in float32 throughout, as the reference's
    # do (phase 19)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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

    clock = PhaseClock()
    clock.start(2, "pairwise_topk kernel vs plain version")
    pw_err = phase_pairwise(dev, kitti, porto, rng)
    clock.start(3, "grid_round kernel vs plain version")
    kitti_sched, grid_err, heavy, few_rows = phase_grid(dev, kitti_np, rng)
    log(f"  (schedule of {len(kitti_sched[0].radii)} rounds)")
    clock.start(4, "main path, trueknn KnnSpec(8) self-query on kitti 2^20")
    index, (b1, b2), main_counts, radius, walls = phase_main(dev, kitti_np,
                                                             rng)
    clock.start(5, "brute RangeSpec at full width")
    range_counts, q, qid, thr, range_err, range5 = phase_range(
        dev, kitti_np, radius, rng)
    clock.start(6, "porto 2^18, fused and host loop")
    phase_porto(dev, rng)
    clock.start(7, "kernel times at main-path shapes")
    pw_t, samp_t, g_t, heavy_t, wide_rows = phase_times(
        dev, index, b1, q, qid, thr, heavy, rng)
    clock.start(8, "grid_round's two designs on every scheduled grid")
    sweep = phase_designs(dev, kitti_sched)
    del kitti_sched
    tally = {"pairwise_topk": 0, "grid_round": 0, WIDE: 0, GWIDE: 0}
    clock.start(9, f"fixed_radius on kitti 2^20 at r = {radius:.6g}")
    fr_index, h1 = phase_fixed_radius(dev, kitti_np, radius, range5, rng,
                                      tally)
    clock.start(10, "generic routes on 4096 rows")
    route_s = phase_routes(dev, kitti_np, index, fr_index, rng, tally)
    clock.start(11, "all-pairs self-queries, kNN graph and DBSCAN")
    range_rounds, graph11 = phase_all_pairs(dev, index, fr_index, b2, radius,
                                            tally)
    clock.stop(f"; phases 9-11 launches {tally}; route seconds "
               f"{json.dumps(route_s)}")
    del fr_index
    clock.start(22, "the deprecated entry forms on kitti 2^20: trueknn(), "
                "brute_knn, fixed_radius_knn, query(q, k)")
    phase_legacy(dev, kitti_np, index, b1, walls[0], range5, radius, h1,
                 tally)
    del h1
    clock.start(12, "distributed dense, 4 positions on one card, kitti 2^22")
    mesh = phase_distributed(dev, rng, tally)
    clock.start(13, "distributed_trueknn_grid on phase 12's mesh, uniform "
                "2^21")
    phase_distributed_grid(dev, mesh, rng, tally)
    clock.start(14, "sharded (placement='host') over kitti 2^20, 8 trueknn "
                "shards")
    sharded_s, knn14 = phase_sharded(dev, kitti_np, index, b2, range5,
                                     radius, rng, tally)
    clock.stop(f"; seconds {json.dumps(sharded_s)}")
    clock.start(15, "sharded (placement='devices') over kitti 2^20, 8 "
                "trueknn shards on one card")
    placed_s, placed_rows, placed_err, placed = phase_placed(
        dev, kitti_np, index, knn14, range5, radius, tally)
    clock.stop(f"; per batch {json.dumps(placed_s)}")
    clock.start(16, "mutable over a trueknn base of kitti 2^19")
    mutable_s, mut = phase_mutable(dev, kitti_np, range5, radius, tally)
    clock.stop(f"; seconds {json.dumps(mutable_s)}")
    clock.start(17, "NeighborServer on the card, worker thread, tenants "
                "'lidar' (phase 4), 'placed' (phase 15), 'mutable' (phase 16)")
    server_s = phase_server(dev, kitti_np, index, placed, mut, range5,
                            radius, graph11, tally)
    del placed, mut, graph11
    clock.stop(f"; per part {json.dumps(server_s)}")
    clock.start(18, "oracle radii, kNN-LM datastore and the serving launcher")
    apps_s = phase_apps(dev, kitti_np, b2, tally)
    clock.stop(f"; seconds {json.dumps(apps_s)}")
    clock.start(19, "the LM stack: Qwen3-0.6B at full width and depth, "
                "BatchedServer, a kNN-LM datastore of its hidden states, the "
                "other nine architectures at full width")
    lm_s = phase_lm(dev, tally)
    clock.stop(f"; parts qwen {lm_s['qwen_s']:.1f}s, kNN-LM "
               f"{lm_s['store_s']:.1f}s, other architectures "
               f"{lm_s['archs_s']:.1f}s")
    clock.start(20, "training: Qwen3-0.6B at full width and depth, float32 "
                "gradients card vs CPU, the nine other architectures, a "
                "checkpoint restart of SmolLM-135M, the kNN-LM example")
    train_s = phase_train(dev, tally)
    clock.stop("; parts " + ", ".join(
        f"{k} {v:.1f}s" for k, v in train_s["seconds"].items()))
    clock.start(21, "parallelism and the dry-run: the sharded Qwen3-0.6B "
                "step on a (2, 2) mesh, the pipeline, the compressed mean, "
                "the trueknn cell on 256 and 512 positions, launch.dryrun on "
                "meta")
    par = phase_parallel(dev, tally)
    clock.stop("; parts " + ", ".join(
        f"{k} {v:.1f}s" for k, v in par["seconds"].items()))
    log(f"  phases 9-22 launches {tally}")
    slow = sorted(clock.seconds.items(), key=lambda kv: -kv[1])[:5]
    log("  phase seconds " + json.dumps(
        {str(n): round(t, 1) for n, t in clock.seconds.items()})
        + "; slowest " + ", ".join(f"{n}: {t:.1f}s" for n, t in slow))
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
            "launches_k_above_32": main_counts[WIDE] + range_counts[WIDE]
            + tally[WIDE],
            "max_abs_err": max(pw_err, range_err, placed_err,
                               par["topk_err"]),
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": pw_b[0],
            "bound_by": pw_b[1],
            "library_ms": None,
            "held_in": ["phase 2", "phase 5", "phase 9", "phase 10",
                        "phase 11", "phase 12", "phase 15", "phase 17",
                        "phase 18", "phase 19", "phase 20", "phase 21",
                        "phase 22"],
            "shapes": [
                shape_row(tag, *t[:3], splits=t[3][0], first_pass_ms=t[3][1],
                          merge_ms=t[3][2])
                for tag, t in (("Q=4096 N=2^20 d=3 k=32 range", pw_t),
                               ("Q=100 N=2^20 d=3 k=5 sampler", samp_t))
            ] + wide_rows + placed_rows,
        },
        {
            "name": "grid_round",
            "route": "cuda",
            "source": "src/repro_torch/csrc/grid_round.cu",
            "replaces": "src/repro/core/fixed_radius.py:36",
            "launches": main_counts["grid_round"]
            + range_counts["grid_round"] + tally["grid_round"],
            "launches_k_above_32": main_counts[GWIDE] + range_counts[GWIDE]
            + tally[GWIDE],
            # one launch runs the round's pass and, on a coarse grid, the
            # merge of its splits (which returns at once when S = 1)
            "passes": ["grid_round_kernel (fine, k <= 32)",
                       "grid_round_fine_warp_kernel (fine, k > 32)",
                       "grid_round_tiled_kernel (coarse, k <= 32)",
                       "grid_round_warp_kernel (coarse, k > 32)",
                       "grid_round_merge_kernel (coarse, S > 1)"],
            "max_abs_err": grid_err,
            "ms": g_k,
            "plain_ms": g_p,
            "bound_ms": g_b[0],
            "bound_by": g_b[1],
            "library_ms": None,
            "held_in": ["phase 3", "phase 7", "phase 8", "phase 9",
                        "phase 10", "phase 11", "phase 13", "phase 14",
                        "phase 16", "phase 17", "phase 18", "phase 19",
                        "phase 20", "phase 21", "phase 22"],
            "design_sweep": sweep,
            "shapes": [
                shape_row("round 0 of batch 1 Q=2^20 k=8", g_k, g_p, g_b),
                shape_row(f"heaviest round t={heavy[2]} Q=2^20 k=8 "
                          f"res={heavy[0].res} cap={heavy[0].cap}",
                          *heavy_t[:3], n_tests=heavy_t[3]),
            ] + few_rows + [
                shape_row(f"counted range round Q=2^20 k={k} {design}", ms,
                          None, b, n_tests=nt)
                for k, design, ms, b, nt in range_rounds
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
