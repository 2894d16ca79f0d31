"""ShardedIndex (port of ``repro.api.backends.sharded``) — a
spatially-partitioned composite index.  ``backend="sharded"``.

TrueKNN's iterative radius growth (paper Alg. 3) is embarrassingly
partitionable: split the cloud spatially, and a query whose current search
radius is r can only find neighbors in shards whose AABB lies within r —
exactly the search-space restriction RTNN exploits.  This backend is that
composition as a *fabric*: a ``repro_torch.core.partition`` split (Morton
or grid cells, per-shard AABBs) feeds N child indexes of any registered
backend, the planner's :func:`repro_torch.api.planner.shard_visit_mask`
prunes shard visits against each query's current radius, and
``repro_torch.core.result.merge_knn`` / ``merge_range`` fold the per-shard
answers back together — bit-identical to the equivalent monolithic index,
because shards preserve global index order (tie-breaking survives) and
bounds are deflated so float32 engine rounding can only cost an extra
visit, never a missed neighbor.

Per spec kind:

* ``KnnSpec(k)`` runs TrueKNN-style rounds over *shards* with one shared
  radius cut: each round grows the cut geometrically (seeded by the fused
  warm-start estimate) and searches every in-cut shard with a single
  radius-capped child pass — the monolith's round shape restricted to
  unpruned shards, so ``n_tests`` tracks the monolith.  A query resolves
  once its k-th candidate lies within the searched cut.  ``start_radius``
  seeds the schedule (never bounds the answer); ``stop_radius`` routes to
  the planner's cached companion-trueknn fallback with exact monolithic
  semantics (same route as the distributed backend).
* ``RangeSpec(r)`` / ``HybridSpec(k, r)`` cull shards outside ``r`` up
  front — one pruned pass, then the merge.

Every pruned plan tags ``timings["plan"] = "sharded/pruned=<m-of-n>"``
(m of the n potential (query, shard) visits skipped), and ``stats()``
accumulates ``shard_visits`` / ``shard_visits_pruned`` across the index's
life.

Two amortizations ride the QueryPlan surface:

* **Fused warm start.**  kNN children with seed-semantics start radii
  (trueknn/distributed) all start from ONE shared radius estimate — the
  EMA'd 25th percentile of previous batches' merged k-th-NN distances
  (first l2 batch: paper Alg. 2 sampling over the whole cloud, paid once)
  — instead of each shard re-running its own tiny-radius ramp.
* **Canonical visit-set shapes.**  Under a prepared plan
  (``index.prepare``), per-shard query subsets are padded to pow2 sizes,
  so a handful of subset shapes serves every batch mix (the plan's
  ``cache_stats()`` counts them, as the reference's does).

Every child runs on the index's own device, whatever ``child_cfg`` says:
the children's kernels (``grid_round`` for trueknn and fixed_radius,
``pairwise_topk`` for brute and distributed) launch on the card; the
pruning, merges and round schedule are host numpy.

Placement (``placement="devices"``): the shards are *placed*, not looped
over.  Every shard's point block is pinned to a position of a 1-D
``DeviceMesh`` through ``repro_torch.core.distributed.PlacedFabric``, and
each shared-cut round (and each hybrid/range pass) becomes one fabric
dispatch — a ``pairwise_topk`` launch per slot under a visit mask — in
place of S child queries.  The slot arithmetic replicates each metric
route's float32 forms op for op (squared L2 in the diff form with the
square root taken afterwards, the brute engine's L1 sum for knn/hybrid,
the Pallas kernel's per-axis L1 for range, cosine through the normalized
space), and the per-slot lists fold through the same
``topk_merge_rows`` / ``merge_range`` host merges, so placed answers are
bit-identical to the host path and to the monolith.  For l2, l1 and linf
kNN the whole round schedule runs with its carry on the index's device
(``PlacedFabric.fused_rounds``: one host sync a round).  Hot shards split
across free slots when query load skews (``rebalance``), and
``stats()["placement"]`` reports per-position occupancy and the
dispatch and rebalance counters.

cfg:
  n_shards:      partition arity (default 8; clamped to N).  The string
                 ``"auto"`` picks a multiple of the device count of the
                 index's device type (``torch.cuda.device_count()`` on the
                 card, 1 on the CPU) via
                 ``repro_torch.core.partition.balanced_shard_count``.
  child_backend: registry name of the per-shard engine (default
                 "trueknn"; anything registered except "sharded" itself).
  partition:     "morton" | "grid" (see ``repro_torch.core.partition``).
  growth:        per-round radius-cut multiplier for kNN rounds (2.0).
  child_cfg:     cfg dict forwarded to every child's ``build_index``.
  placement:     "host" (default; sequential per-child dispatches) |
                 "devices" (one fabric dispatch per round).
  rebalance_every: placed batches between automatic load-skew checks
                 (32; 0 disables auto rebalancing — ``rebalance()`` stays
                 available).
  mesh:          the 1-D ``DeviceMesh`` the placed blocks live on (the
                 reference's ``jax.devices()``); by default every card of
                 the index's device type (``torch.cuda.device_count()``
                 positions on the card, one on the CPU).  A device may sit
                 at several positions.  Its size is also the device count
                 ``n_shards="auto"`` rounds to.
  device:        "cuda" (default) or "cpu"; the children's and the fused
                 loop's carry too.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ...core.distributed import DeviceMesh, PlacedFabric
from ...core.grid import _next_pow2
from ...core.partition import (
    aabb_max_dists,
    aabb_min_dists,
    balanced_shard_count,
    partition_points,
    shard_occupancy,
)
from ...core.result import (
    KNNResult,
    RangeResult,
    RoundStats,
    merge_knn,
    merge_range,
    slice_rows,
    strip_self_csr,
    strip_self_knn,
    topk_merge_rows,
)

from ..index import NeighborIndex, build_index
from ..metrics import Metric
from ..query import HybridSpec, KnnSpec, RangeSpec
from ..registry import register_backend

__all__ = ["ShardedIndex", "PRUNE_SLACK"]

#: Relative deflation applied to AABB lower bounds before any pruning
#: comparison: the bounds are exact over the reals, but child engines
#: round float32 distances, so a bound must under-promise by more than the
#: engines can under-round.  1e-4 covers the accumulated error of every
#: engine form in this repo with orders of magnitude to spare; the cost is
#: only the occasional shard visited that pure math could have skipped.
PRUNE_SLACK = 1e-4


def _deflate(bounds: np.ndarray) -> np.ndarray:
    return np.maximum(bounds * (1.0 - PRUNE_SLACK) - 1e-12, 0.0)


@register_backend("sharded")
class ShardedIndex(NeighborIndex):
    """Composite index over spatially-partitioned child indexes."""

    native_metrics = frozenset({"l2", "l1", "linf", "cosine"})
    knn_start_radius_semantics = "seed"
    #: canonical visit-set floor under prepared plans: subsets pad to
    #: pow2 sizes no smaller than this, so tiny shard visits share one
    #: shape bucket instead of one per exact subset size
    MIN_SUBSET = 16

    def __init__(
        self,
        points,
        *,
        n_shards=8,
        child_backend: str = "trueknn",
        partition: str = "morton",
        growth: float = 2.0,
        child_cfg: Optional[dict] = None,
        placement: str = "host",
        rebalance_every: int = 32,
        mesh: Optional[DeviceMesh] = None,
        device="cuda",
    ):
        super().__init__(points, device)
        if child_backend == "sharded":
            raise ValueError(
                "sharded children of a sharded index are not supported; "
                "pick a leaf backend (trueknn / fixed_radius / brute / ...)"
            )
        if not growth > 1.0:
            raise ValueError("radius-cut growth factor must exceed 1")
        if placement not in ("host", "devices"):
            raise ValueError(
                f"placement must be 'host' or 'devices', got {placement!r}"
            )
        if mesh is None:
            mesh = DeviceMesh(
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if self._device.type == "cuda" else [self._device],
                ("shard",))
        if mesh.devices.ndim != 1 or mesh.device_type != self._device.type:
            raise ValueError(
                f"mesh must be 1-D on the index's device type "
                f"({self._device.type}), got {mesh}"
            )
        self._growth = float(growth)
        self._child_backend = child_backend
        self._child_cfg = dict(child_cfg or {})
        self._placement = placement
        self._rebalance_every = int(rebalance_every)
        self._mesh = mesh
        self._placed = None  # PlacedFabric, built on first placed dispatch
        self._placed_load = None  # per-shard placed visit counts (rebalance)
        self._slot_maps = None  # (slot layout, per-slot global-idx lookups)
        if n_shards == "auto":
            # a mesh-size multiple (8 per device floor keeps the default
            # arity when only one device exists)
            n_shards = balanced_shard_count(self.n_points, 8,
                                            mesh.devices.size)
        self._part = partition_points(
            self._pts, n_shards, method=partition
        )
        # every child lives on this index's device, whatever child_cfg says
        child_cfg = dict(self._child_cfg, device=self._device)
        self._children = [
            build_index(self._pts[idx], backend=child_backend, **child_cfg)
            for idx in self._part.shards
        ]
        # local child index -> global index, with the child's sentinel
        # (its own N) mapped to the global sentinel (the cloud's N)
        self._gmaps = []
        for idx in self._part.shards:
            g = np.empty((len(idx) + 1,), np.int32)
            g[:-1] = idx
            g[-1] = self.n_points
            self._gmaps.append(g)
        self._aabb_views: dict = {}  # metric name -> transformed AABBs
        # fused cross-shard warm-start seeds, per metric (query-metric
        # units): ONE radius estimate seeds the whole kNN round schedule —
        # every child searches the same growing cut — so no shard ever
        # re-runs its own tiny-radius ramp.  A scheduling seed only;
        # answers never depend on it.
        self._warm_seed: dict = {}
        self._warm_seed_ema = 0.3
        self._sampled_seeds: dict = {}  # metric name -> Alg. 2 seed
        self._seed_children = (
            self._children[0].knn_start_radius_semantics == "seed"
        )
        self._c = {
            "batches": 0,
            "queries_served": 0,
            "shard_visits": 0,
            "shard_visits_pruned": 0,
            "shard_rounds": 0,
            "shard_searches": 0,
            "child_dispatches": 0,
            "fused_dispatches": 0,
            "rebalances": 0,
            # self-batch locality split: rows resolved entirely by their
            # own shard's local pass vs rows that needed shared-cut rounds
            "self_local_rows": 0,
            "self_boundary_rows": 0,
        }

    # -- geometry ----------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self._part.n_shards

    def _transformed_aabbs(self, metric: Metric) -> np.ndarray:
        """Per-shard AABBs over the metric's transformed cloud (cached);
        the monotone L2 reduction makes their L2 excess bound an exact
        metric-space bound after ``dist_from_l2``."""
        ab = self._aabb_views.get(metric.name)
        if ab is None:
            ab = np.empty_like(self._part.aabbs)
            for s, idx in enumerate(self._part.shards):
                t = metric.transform_points(self._pts[idx])
                ab[s, 0] = t.min(0)
                ab[s, 1] = t.max(0)
            self._aabb_views[metric.name] = ab
        return ab

    def _bounds(self, q: np.ndarray, metric: Metric) -> np.ndarray:
        """(Q, S) deflated metric-space lower bounds (0 = cannot prune)."""
        if metric.name in ("l1", "linf"):
            b = aabb_min_dists(self._part.aabbs, q, metric.name)
        elif metric.name == "l2":
            b = aabb_min_dists(self._part.aabbs, q, "l2")
        elif metric.has_l2_view:
            tq = metric.transform_points(np.asarray(q, np.float32))
            b = np.asarray(
                metric.dist_from_l2(
                    aabb_min_dists(self._transformed_aabbs(metric), tq, "l2")
                ),
                np.float64,
            )
        else:  # unprunable metric: visit everything, stay exact
            return np.zeros((q.shape[0], self.n_shards))
        return _deflate(b)

    def _bounds_upper(self, q: np.ndarray, metric: Metric) -> np.ndarray:
        """(Q, S) inflated metric-space upper bounds (farthest corner): a
        search radius past every shard's bound has provably covered the
        cloud — the kNN round loop's termination guard when fewer than k
        candidates exist."""
        if metric.name in ("l1", "linf", "l2"):
            b = aabb_max_dists(self._part.aabbs, q, metric.name)
        elif metric.has_l2_view:
            tq = metric.transform_points(np.asarray(q, np.float32))
            b = np.asarray(
                metric.dist_from_l2(
                    aabb_max_dists(self._transformed_aabbs(metric), tq, "l2")
                ),
                np.float64,
            )
        else:  # no bound: rely on the k-th-candidate criterion alone
            return np.full((q.shape[0], self.n_shards), np.inf)
        return b * (1.0 + PRUNE_SLACK) + 1e-12

    # -- shared plumbing ---------------------------------------------------

    def _prep(self, queries):
        """(rows, self_ids): explicit query rows plus, for the dataset-
        queries-itself form, each row's own global index (children get
        explicit rows and one extra candidate slot; the self match is
        stripped after the merge, reproducing monolithic self-exclusion —
        duplicates of the query point at other indices are kept, exactly
        as ``query_ids`` exclusion keeps them)."""
        if queries is None:
            return self._pts, np.arange(self.n_points, dtype=np.int64)
        return np.asarray(queries, np.float32), None

    def _query_child(self, s: int, rows, spec, metric: Metric, ctx=None):
        """Run one shard's child index over a visit-set.

        Under a prepared plan (``ctx.canonical_shapes``), the subset is
        padded to the next power of two (copies of its first row, sliced
        off the answer) so the child engines see a handful of canonical
        subset shapes however the batch's shard mix varies, as in the
        reference; the plan's ``cache_stats()`` counts each (shard, kind,
        shape) bucket.  The context is threaded into the child's planner
        call, so warm-start seeds and nested bucket accounting survive the
        hop.
        """
        from ..planner import execute

        rows = np.asarray(rows, np.float32)
        m = rows.shape[0]
        if ctx is not None and ctx.canonical_shapes:
            # floor at MIN_SUBSET rows: tiny visit-sets collapse into ONE
            # canonical shape
            m_pad = _next_pow2(max(m, self.MIN_SUBSET))
            ctx.record_bucket(
                ("shard", s, spec.kind, getattr(spec, "k", None), m_pad)
            )
            if m_pad > m:
                rows = np.concatenate(
                    [rows, np.repeat(rows[:1], m_pad - m, axis=0)]
                )
        self._c["child_dispatches"] += 1
        res = execute(self._children[s], rows, spec, metric.name, ctx)
        if rows.shape[0] > m:
            res = slice_rows(res, m)
        return res

    # -- device placement --------------------------------------------------

    def _use_placed(self, metric: Metric) -> bool:
        """Placed dispatch serves every metric whose host child route runs
        raw L1/Linf arithmetic or a (possibly transformed) squared-L2
        engine; anything else keeps the sequential host loop."""
        return self._placement == "devices" and (
            metric.name in ("l2", "l1", "linf") or metric.has_l2_view
        )

    def _fabric(self) -> PlacedFabric:
        """The placed fabric, built lazily on the first placed dispatch so
        host-mode indexes never place blocks."""
        if self._placed is None:
            self._placed = PlacedFabric(
                [self._pts[idx] for idx in self._part.shards],
                mesh=self._mesh, device=self._device,
            )
            self._placed_load = np.zeros((self.n_shards,), np.float64)
        return self._placed

    def _slot_gmaps(self, fab) -> list:
        """Per-slot local-row -> global-index lookups (the fabric's
        invalid-candidate code, row B, maps to the global sentinel N);
        rebuilt whenever a rebalance changes the slot layout."""
        key = tuple(fab.slots)
        if self._slot_maps is None or self._slot_maps[0] != key:
            B, n = fab.block_rows, self.n_points
            maps = []
            for (s, lo, hi) in fab.slots:
                lk = np.full((B + 1,), n, np.int32)
                if s >= 0 and hi > lo:
                    lk[: hi - lo] = self._gmaps[s][:-1][lo:hi]
                maps.append(lk)
            self._slot_maps = (key, maps)
        return self._slot_maps[1]

    def _placed_route(self, metric: Metric, kind: str) -> tuple:
        """(point space, distance form) for one dispatch, chosen so the
        slot arithmetic is op for op the host child route's: raw squared
        L2 for the grid engines, the brute engine's L1 sum for
        knn/hybrid, the Pallas kernel's per-axis L1 for range, and the
        transformed (e.g. normalized) space for l2-view metrics."""
        if metric.name == "l2":
            return "raw", "sq_l2"
        if metric.name == "l1":
            return "raw", ("l1_acc" if kind == "range" else "l1")
        if metric.name == "linf":
            return "raw", "linf"
        return metric.name, "sq_l2"

    def _placed_threshold(self, metric: Metric, r: float) -> float:
        """The in-radius threshold in raw engine units — bitwise the value
        the host kernels compare against (``float32(r)**2`` for the
        squared-L2 engines, the raw radius for L1/Linf)."""
        if metric.name == "l2":
            return float(np.float32(float(r)) ** 2)
        if metric.name in ("l1", "linf"):
            return float(r)
        return float(np.float32(metric.radius_to_l2(float(r))) ** 2)

    def _placed_cutmap(self, metric: Metric, r: float, d_raw):
        """Host-side radius cut + metric mapping of one slot's raw
        distances: (mapped dists with inf beyond the cut, keep mask),
        each child route's exact float ops (the ``d2 <= float32(r)**2``
        cut with ``np.sqrt`` for squared-L2 engines, a plain ``<=`` on raw
        L1/Linf)."""
        if metric.name == "l2":
            keep = d_raw <= np.float32(float(r)) ** 2
            d = np.where(keep, np.sqrt(d_raw), np.inf).astype(np.float32)
        elif metric.name in ("l1", "linf"):
            keep = d_raw <= float(r)
            d = np.where(keep, d_raw, np.inf).astype(np.float32)
        else:
            rl2 = metric.radius_to_l2(float(r))
            keep = d_raw <= np.float32(rl2) ** 2
            d = np.where(
                keep,
                np.asarray(metric.dist_from_l2(np.sqrt(d_raw)), np.float32),
                np.inf,
            ).astype(np.float32)
        return d, keep

    def _placed_dispatch(self, fab, space, form, tq, visit_rows, active,
                         k: int, ctx, kind: str, threshold=np.inf):
        """ONE fabric dispatch over the batch's active rows.

        Pads the row count to the canonical pow2 shape under a prepared
        plan (zero rows, masked out, sliced off here) and expands the
        (row, shard) visit matrix to the fabric's slot axis.  Returns
        (dists (slots, A, k), idxs, counts (slots, A), padded rows) on
        the host, raw-form distances — the callers cut and map them."""
        rows = tq[active]
        m = rows.shape[0]
        m_pad = m
        if ctx is not None and ctx.canonical_shapes:
            from ..plan import canonical_rows

            m_pad = canonical_rows(m, self.MIN_SUBSET)
            ctx.record_bucket(("placed", kind, form, k, m_pad))
        if m_pad > m:
            rows = np.concatenate(
                [rows, np.zeros((m_pad - m, rows.shape[1]), np.float32)]
            )
        vm = np.zeros((fab.n_slots, m_pad), bool)
        for j, (s, _lo, _hi) in enumerate(fab.slots):
            if s >= 0:
                vm[j, :m] = visit_rows[:, s]
        d, i, cnt = fab.topk(space, form, rows, vm, k, threshold)
        self._c["fused_dispatches"] += 1
        return d[:, :m], i[:, :m], cnt[:, :m], m_pad

    def rebalance(self, shard: Optional[int] = None) -> bool:
        """Split the given (default: hottest by placed query load, else
        largest) shard's biggest slot across a free slot of the padded
        slot axis.  Exact: a shard's slots are contiguous sub-ranges whose
        per-slot lists fold to the same merged answer.  Returns True iff a
        split happened (needs placement="devices", a free slot and a
        splittable shard)."""
        if self._placement != "devices":
            return False
        fab = self._fabric()
        if shard is None:
            load = self._placed_load
            if load is not None and load.sum() > 0:
                shard = int(np.argmax(load))
            else:
                shard = int(np.argmax(self._part.sizes))
        ok = fab.rebalance(int(shard))
        if ok:
            self._c["rebalances"] += 1
        return ok

    def _maybe_rebalance(self) -> None:
        """Auto-trigger: every ``rebalance_every`` placed batches, split
        the hottest shard when its visit load exceeds twice the mean."""
        if self._rebalance_every <= 0 or self._placed is None:
            return
        if self._c["batches"] % self._rebalance_every:
            return
        load = self._placed_load
        if load is None or load.sum() <= 0:
            return
        if load.max() > 2.0 * load.mean():
            self.rebalance(int(load.argmax()))
        load[:] = 0.0

    # -- fused cross-shard warm start --------------------------------------

    def _sample_seed(self, metric: Metric) -> float:
        """Paper Alg. 2 (min 4-NN distance of 100 samples) over the whole
        cloud — paid once instead of once per shard.  l2 goes through the
        shared fast-kernel helper; other metrics fall back to the
        registry's reference ``pairwise`` (dense, but 100 x N once)."""
        if metric.name == "l2":
            from ...core.sampling import sample_start_radius

            return float(sample_start_radius(self._pts_t))
        n = self.n_points
        rng = np.random.default_rng(0)
        sel = rng.choice(n, size=min(100, n), replace=False)
        D = np.asarray(metric.pairwise(self._pts[sel], self._pts))
        D[np.arange(len(sel)), sel] = np.inf  # self matches
        kq = min(4, n - 1)
        d = np.sort(D, axis=1)[:, :kq]
        d = d[np.isfinite(d) & (d > 0)]
        return float(d.min()) if d.size else 1e-6

    def _fused_seed(self, metric: Metric, ctx=None) -> float:
        """One shared start radius for the whole kNN round schedule: the
        per-metric EMA of previous batches' resolved radii, a prepared
        plan's cross-plan seed, or (first batch) Alg. 2 sampling over the
        whole cloud.  A scheduling seed only — answers never depend on
        it."""
        r = self._warm_seed.get(metric.name)
        if r is None and ctx is not None and ctx.warm_radius is not None:
            r = ctx.warm_radius
        if r is None:
            r = self._sampled_seeds.get(metric.name)
            if r is None:
                r = self._sample_seed(metric)
                self._sampled_seeds[metric.name] = r
        return float(r)

    def _update_seed(self, resolved_radii, metric: Metric, ctx=None) -> None:
        """Refine the fused seed from the radii at which this batch's
        queries resolved (25th percentile, EMA'd — the same statistic the
        trueknn backend's own warm start tracks), and publish it to the
        executing plan for cross-plan reuse."""
        fin = np.asarray(resolved_radii, np.float64)
        fin = fin[np.isfinite(fin)]
        if not fin.size:
            return
        target = max(float(np.percentile(fin, 25.0)), 1e-12)
        prev = self._warm_seed.get(metric.name)
        if prev is None:
            self._warm_seed[metric.name] = target
        else:
            w = self._warm_seed_ema
            self._warm_seed[metric.name] = (1.0 - w) * prev + w * target
        if ctx is not None:
            ctx.warm_radius = self._warm_seed[metric.name]

    def _child_round_spec(self, k_child: int, r: float, metric: Metric):
        """The spec that asks a child for its k best *within radius r* in
        one cheap pass: a degenerate ``start == stop`` KnnSpec on
        radius-scheduled children (exactly one grid round at r — no
        per-shard ramp), a plain HybridSpec otherwise (schedule-free
        children run one dense/grid pass with the cut applied; children
        that reject ``stop_radius`` outright — the distributed engine —
        must not be handed a spec the planner would detour around their
        own engine to serve)."""
        spec = KnnSpec(k_child, start_radius=r, stop_radius=r)
        if (
            self._seed_children
            and self._children[0].supports_knn_spec(spec)
            and (
                metric.name in self._children[0].native_metrics
                or metric.has_l2_view
            )
        ):
            return spec
        return HybridSpec(k_child, r)

    def _self_local_pass(self, k: int, k_eff: int, metric: Metric, ctx=None):
        """Shard-local leg of a self-batch: every shard answers its OWN
        rows with its native self-query path (``queries=None`` — exact
        self-excluded top-k, one dispatch per shard, device buffer reuse
        and all), scattered into a global (N, k_eff) seed pool.  Returns
        ``(local_d, local_i, n_tests)``; rows in shards too small to hold
        k neighbors keep inf/sentinel tails and resolve through the
        shared-cut rounds."""
        from ..planner import execute

        n = self.n_points
        local_d = np.full((n, k_eff), np.inf, np.float32)
        local_i = np.full((n, k_eff), n, np.int32)
        tests = 0
        for s, idx in enumerate(self._part.shards):
            nc = len(idx)
            k_loc = min(k, nc - 1)
            if k_loc < 1:
                continue  # empty or single-point shard: only itself inside
            self._c["child_dispatches"] += 1
            res = execute(
                self._children[s], None, KnnSpec(k_loc), metric.name, ctx
            )
            tests += int(res.n_tests)
            local_d[idx, :k_loc] = np.asarray(res.dists)
            local_i[idx, :k_loc] = self._gmaps[s][np.asarray(res.idxs)]
        return local_d, local_i, tests

    def _scatter_knn(self, res, sel, q_total: int, width: int, s: int):
        """Lift a child's subset answer to a full-Q, global-index part."""
        d = np.full((q_total, width), np.inf, np.float32)
        i = np.full((q_total, width), self.n_points, np.int32)
        cd = np.asarray(res.dists)
        ci = self._gmaps[s][np.asarray(res.idxs)]
        d[sel, : cd.shape[1]] = cd
        i[sel, : ci.shape[1]] = ci
        # child `found` values are shard-capped counts that do NOT
        # partition a global count — dropped here so merge_knn never
        # materializes their misleading sum (the backend reports the
        # returned-neighbor count instead)
        return KNNResult(
            dists=d,
            idxs=i,
            n_tests=int(res.n_tests),
            backend=res.backend,
            metric=res.metric,
            rounds=res.rounds,
        )

    def _scatter_range(self, res, sel, q_total: int, s: int):
        counts = np.zeros((q_total,), np.int64)
        counts[sel] = res.counts
        offsets = np.zeros((q_total + 1,), np.int64)
        np.cumsum(counts, out=offsets[1:])
        truncated = None
        if res.truncated is not None:
            truncated = np.zeros((q_total,), bool)
            truncated[sel] = res.truncated
        return RangeResult(
            offsets=offsets,
            idxs=self._gmaps[s][np.asarray(res.idxs)],
            dists=np.asarray(res.dists, np.float32),
            radius=res.radius,
            n_tests=int(res.n_tests),
            backend=res.backend,
            metric=res.metric,
            truncated=truncated,
        )

    # self-exclusion strippers live in ``repro_torch.core.result`` (shared
    # with the mutable composite); kept as staticmethods for callers that
    # reach them through the class
    _strip_self_knn = staticmethod(strip_self_knn)
    _strip_self_csr = staticmethod(strip_self_csr)

    def _account(self, q_total: int, visited: int, t0: float, res,
                 dispatches: Optional[int] = None):
        from ..planner import placed_plan_tag, shard_plan_tag

        potential = q_total * self.n_shards
        self._c["batches"] += 1
        self._c["queries_served"] += q_total
        self._c["shard_visits"] += visited
        self._c["shard_visits_pruned"] += potential - visited
        res.timings.update(
            plan=(
                shard_plan_tag(visited, potential)
                if dispatches is None
                else placed_plan_tag(visited, potential, dispatches)
            ),
            shard_visits=visited,
            shard_potential=potential,
            query_seconds=time.perf_counter() - t0,
        )
        if dispatches is not None:
            res.timings["fused_dispatches"] = int(dispatches)
            self._maybe_rebalance()
        res.backend = self.backend_name
        return res

    # -- planner contract --------------------------------------------------

    def supports_knn_spec(self, spec: KnnSpec) -> bool:
        # stop_radius semantics are defined by ONE radius schedule over
        # the whole cloud; per-shard schedules diverge, so the planner's
        # companion-trueknn fallback answers with monolithic semantics
        return spec.stop_radius is None

    def plan_details(self, spec, metric: Metric) -> tuple:
        props = {
            "n_shards": self.n_shards,
            "partition": self._part.method,
            "child_backend": self._child_backend,
            "pruning": (
                "shared radius cut grown over rounds"
                if isinstance(spec, KnnSpec)
                else "up-front radius cull"
            ),
            "warm_seed": self._warm_seed.get(metric.name),
            "placement": self._placement,
        }
        if self._placement == "devices" and self._placed is not None:
            props["devices"] = self._placed.n_devices
            props["slots"] = self._placed.n_slots

        def children():  # built on first explain(): one-shot plans skip it
            from ..planner import build_plan

            nodes = []
            for s, child in enumerate(self._children):
                nc = child.n_points
                if isinstance(spec, KnnSpec):
                    cs = KnnSpec(min(spec.k, nc))
                elif isinstance(spec, HybridSpec):
                    cs = HybridSpec(min(spec.k, nc), spec.radius)
                else:
                    cs = spec
                node = build_plan(child, cs, metric.name)
                node.props = dict(node.props, shard=s, shard_points=nc)
                nodes.append(node)
            return nodes

        return "sharded/pruned=<m-of-n>", props, children

    # -- spec execution ----------------------------------------------------

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        """TrueKNN rounds over the fabric: one *shared* radius cut grows
        geometrically from the fused warm seed; each round, every
        unresolved query searches every shard within the cut — a single
        radius-capped pass per (shard, round), exactly the monolith's
        round shape restricted to unpruned shards, so the work metric
        tracks the monolith instead of paying a full unbounded
        within-shard kNN per visit.  A query resolves once its k-th
        candidate lies within the searched cut (everything within the cut
        has provably been pooled), or the cut covers the whole cloud.
        The pool is rebuilt from the round's (complete-within-cut) parts,
        so re-searched shards never duplicate candidates."""
        if spec.stop_radius is not None:
            # belt and braces for direct hook calls; the planner never
            # routes here (supports_knn_spec said no)
            raise NotImplementedError
        if self._use_placed(metric):
            return self._execute_knn_placed(queries, spec, metric, ctx)
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        q_total, n, s_total = q.shape[0], self.n_points, self.n_shards
        k = spec.k
        k_eff = k + (1 if self_ids is not None else 0)
        pool_d = np.full((q_total, k_eff), np.inf, np.float32)
        pool_i = np.full((q_total, k_eff), n, np.int32)
        bounds = self._bounds(q, metric)
        cover = self._bounds_upper(q, metric).max(axis=1)  # (Q,)
        floor = bounds.min(axis=1)  # nearest shard per query
        # the caller's explicit start_radius is a schedule seed (never a
        # bound); otherwise one fused estimate seeds every shard's rounds
        seed = (
            float(spec.start_radius)
            if spec.start_radius is not None
            else self._fused_seed(metric, ctx)
        )
        unresolved = np.ones((q_total,), bool)
        resolved_at = np.full((q_total,), np.nan)
        ever = np.zeros((q_total, s_total), bool)  # unique-visit accounting
        rounds: list = []
        total_tests = 0
        searches = 0
        r = 0.0
        # self-batch locality pre-pass: each shard's rows query their OWN
        # block first (the child's exact self-excluded top-k, one self
        # dispatch per shard).  Rows whose k-th local candidate is provably
        # closer than anything any other shard can hold resolve right here;
        # only boundary rows enter the shared-cut rounds — and never
        # re-visit their own shard (the local unbounded top-k dominates any
        # radius-capped re-search of the same block).
        assign = self._part.assign
        local_d = local_i = None
        n_local = 0
        if self_ids is not None and q_total == n:
            local_d, local_i, local_tests = self._self_local_pass(
                k, k_eff, metric, ctx
            )
            total_tests += local_tests
            searches += q_total
            ever[np.arange(q_total), assign] = True
            pool_d[:] = local_d
            pool_i[:] = local_i
            # strictly-< against the deflated lower bounds: any foreign
            # point sits at >= its shard's bound, so kth strictly below
            # every other shard's bound can never be displaced (nor tied)
            kth_seed = local_d[:, k - 1].astype(np.float64)
            other = bounds.copy()
            other[np.arange(q_total), assign] = np.inf
            interior = kth_seed < other.min(axis=1)
            resolved_at[interior] = kth_seed[interior]
            unresolved &= ~interior
            n_local = int(interior.sum())
            self._c["self_local_rows"] += n_local
            self._c["self_boundary_rows"] += q_total - n_local
        while unresolved.any():
            tr = time.perf_counter()
            pend = floor[unresolved]
            pend = pend[np.isfinite(pend)]
            base = float(pend.min()) if pend.size else 0.0
            if not rounds:
                r = max(seed, base, 1e-12)
            else:
                # geometric growth; jump straight to the nearest pending
                # shard when every remaining query is farther than that
                r = max(r * self._growth, base)
            visit_now = unresolved[:, None] & shard_visit_mask(bounds, r)
            # fresh pool rows for this round's searchers: the round's parts
            # are complete within r, and re-searched shards would otherwise
            # duplicate candidates already pooled at a smaller cut
            if local_d is not None:
                # re-seed from the local pass (the own-shard part of every
                # round's pool) — own shards are masked out of the visits
                visit_now[np.arange(q_total), assign] = False
                pool_d[unresolved] = local_d[unresolved]
                pool_i[unresolved] = local_i[unresolved]
            else:
                pool_d[unresolved] = np.inf
                pool_i[unresolved] = n
            round_tests = 0
            for s in range(s_total):
                sel = np.flatnonzero(visit_now[:, s])
                if not sel.size:
                    continue
                k_child = min(k_eff, self._children[s].n_points)
                res = self._query_child(
                    s, q[sel], self._child_round_spec(k_child, r, metric),
                    metric, ctx,
                )
                round_tests += int(res.n_tests)
                cd = np.asarray(res.dists)
                ci = self._gmaps[s][np.asarray(res.idxs)]
                pool_d[sel], pool_i[sel] = topk_merge_rows(
                    pool_d[sel], pool_i[sel], cd, ci, k_eff
                )
                searches += int(sel.size)
            ever |= visit_now
            total_tests += round_tests
            # resolved: the k-th best (self excluded) lies within the
            # searched cut — or the cut provably covers the whole cloud
            if self_ids is not None:
                has_self = (pool_i == self_ids[:, None]).any(axis=1)
                kth = np.where(has_self, pool_d[:, k], pool_d[:, k - 1])
            else:
                kth = pool_d[:, k - 1]
            resolved = unresolved & ((kth <= r) | (r >= cover))
            rounds.append(
                RoundStats(
                    len(rounds),
                    float(r),
                    int(unresolved.sum()),
                    int(resolved.sum()),
                    round_tests,
                    (),
                    0,
                    time.perf_counter() - tr,
                )
            )
            resolved_at[resolved] = r
            unresolved &= ~resolved
        self._c["shard_rounds"] += len(rounds)
        self._c["shard_searches"] += searches
        if self_ids is not None:
            d, i = self._strip_self_knn(pool_d, pool_i, self_ids, k, n)
        else:
            d, i = pool_d[:, :k], pool_i[:, :k]
        self._update_seed(resolved_at, metric, ctx)
        out = KNNResult(
            dists=d,
            idxs=i,
            n_tests=total_tests,
            metric=metric.name,
            # the returned-neighbor count (= min(k, reachable candidates));
            # per-child "found" values are round-local and do NOT partition
            # a global count, so summing them would overstate wildly
            found=np.isfinite(d).sum(axis=1).astype(np.int64),
            rounds=rounds,
            final_radius=rounds[-1].radius if rounds else None,
        )
        out.timings["shard_searches"] = searches
        if local_d is not None:
            out.timings["self_local_rows"] = n_local
            out.timings["self_boundary_rows"] = q_total - n_local
        return self._account(q_total, int(ever.sum()), t0, out)

    def _execute_knn_placed(self, queries, spec: KnnSpec, metric: Metric,
                            ctx=None) -> KNNResult:
        """The shared-cut round loop with ONE fabric dispatch per round:
        every slot computes its unbounded per-row top-k under the visit
        mask, the round's radius cut is applied on the host with each
        metric route's exact float ops, and the slot lists fold through
        the same ``topk_merge_rows`` pool — the host loop's schedule,
        resolution criterion and answers, bit for bit, without the S
        child queries per round."""
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        if metric.name in ("l2", "l1", "linf") and q.shape[0] and \
                self.n_points:
            # raw-arithmetic metrics run the whole schedule on device;
            # l2-view metrics (cosine) keep the per-round loop below —
            # their radius mapping is host float64 arithmetic by contract
            return self._execute_knn_placed_fused(
                t0, q, self_ids, spec, metric, ctx
            )
        q_total, n, s_total = q.shape[0], self.n_points, self.n_shards
        k = spec.k
        k_eff = k + (1 if self_ids is not None else 0)
        fab = self._fabric()
        space, form = self._placed_route(metric, "knn")
        if space != "raw" and not fab.has_space(space):
            fab.add_space(space, metric.transform_points)
        tq = q if space == "raw" else metric.transform_points(q)
        pool_d = np.full((q_total, k_eff), np.inf, np.float32)
        pool_i = np.full((q_total, k_eff), n, np.int32)
        bounds = self._bounds(q, metric)
        cover = self._bounds_upper(q, metric).max(axis=1)  # (Q,)
        floor = bounds.min(axis=1)  # nearest shard per query
        seed = (
            float(spec.start_radius)
            if spec.start_radius is not None
            else self._fused_seed(metric, ctx)
        )
        unresolved = np.ones((q_total,), bool)
        resolved_at = np.full((q_total,), np.nan)
        ever = np.zeros((q_total, s_total), bool)
        rounds: list = []
        total_tests = 0
        searches = 0
        dispatches = 0
        r = 0.0
        while unresolved.any():
            tr = time.perf_counter()
            pend = floor[unresolved]
            pend = pend[np.isfinite(pend)]
            base = float(pend.min()) if pend.size else 0.0
            if not rounds:
                r = max(seed, base, 1e-12)
            else:
                r = max(r * self._growth, base)
            visit_now = unresolved[:, None] & shard_visit_mask(bounds, r)
            pool_d[unresolved] = np.inf
            pool_i[unresolved] = n
            round_tests = 0
            active = np.flatnonzero(visit_now.any(axis=1))
            if active.size:
                d_sl, i_sl, _cnt, m_pad = self._placed_dispatch(
                    fab, space, form, tq, visit_now[active], active,
                    k_eff, ctx, "knn",
                )
                dispatches += 1
                round_tests = int(m_pad) * n  # dense: every valid row
                maps = self._slot_gmaps(fab)
                for j, (s, lo, hi) in enumerate(fab.slots):
                    if s < 0 or hi <= lo:
                        continue
                    sel = np.flatnonzero(visit_now[:, s])
                    if not sel.size:
                        continue
                    pos = np.searchsorted(active, sel)
                    cd, keep = self._placed_cutmap(metric, r, d_sl[j][pos])
                    ci = np.where(
                        keep, maps[j][i_sl[j][pos]], n
                    ).astype(np.int32)
                    pool_d[sel], pool_i[sel] = topk_merge_rows(
                        pool_d[sel], pool_i[sel], cd, ci, k_eff
                    )
                searches += int(visit_now.sum())
                self._placed_load += visit_now.sum(axis=0)
            ever |= visit_now
            total_tests += round_tests
            if self_ids is not None:
                has_self = (pool_i == self_ids[:, None]).any(axis=1)
                kth = np.where(has_self, pool_d[:, k], pool_d[:, k - 1])
            else:
                kth = pool_d[:, k - 1]
            resolved = unresolved & ((kth <= r) | (r >= cover))
            rounds.append(
                RoundStats(
                    len(rounds),
                    float(r),
                    int(unresolved.sum()),
                    int(resolved.sum()),
                    round_tests,
                    (),
                    0,
                    time.perf_counter() - tr,
                )
            )
            resolved_at[resolved] = r
            unresolved &= ~resolved
        self._c["shard_rounds"] += len(rounds)
        self._c["shard_searches"] += searches
        if self_ids is not None:
            d, i = self._strip_self_knn(pool_d, pool_i, self_ids, k, n)
        else:
            d, i = pool_d[:, :k], pool_i[:, :k]
        self._update_seed(resolved_at, metric, ctx)
        out = KNNResult(
            dists=d,
            idxs=i,
            n_tests=total_tests,
            metric=metric.name,
            found=np.isfinite(d).sum(axis=1).astype(np.int64),
            rounds=rounds,
            final_radius=rounds[-1].radius if rounds else None,
        )
        out.timings["shard_searches"] = searches
        return self._account(
            q_total, int(ever.sum()), t0, out, dispatches=dispatches
        )

    def _execute_knn_placed_fused(self, t0, q, self_ids, spec: KnnSpec,
                                  metric: Metric, ctx=None) -> KNNResult:
        """The shared-cut round loop with its carry on the index's device:
        the radius schedule, per-shard visit masks, candidate pools and
        the resolution criterion are tensors there
        (``PlacedFabric.fused_rounds``: a kernel launch per slot and
        round, one host sync a round), one fused dispatch per *batch*.
        Answers are the host loop's bit for bit: per-slot distances use
        the same arithmetic contract, the cut is the same engine-exact
        compare, and the merge's ascending (dist, index) order is exactly
        the ``topk_merge_rows`` fold.  The device schedule runs in float32
        (the host's is float64), which can shift *when* a query resolves
        by a round — never *what* it answers, because a resolved pool is
        provably the exact global top-k whatever cut resolved it."""
        q_total, n, s_total = q.shape[0], self.n_points, self.n_shards
        k = spec.k
        k_eff = k + (1 if self_ids is not None else 0)
        fab = self._fabric()
        space, form = self._placed_route(metric, "knn")
        bounds = self._bounds(q, metric)
        cover = self._bounds_upper(q, metric).max(axis=1)
        floor = bounds.min(axis=1)
        seed = (
            float(spec.start_radius)
            if spec.start_radius is not None
            else self._fused_seed(metric, ctx)
        )
        m_pad = q_total
        if ctx is not None and ctx.canonical_shapes:
            from ..plan import canonical_rows

            m_pad = canonical_rows(q_total, self.MIN_SUBSET)
            ctx.record_bucket(("placed-fused", form, k_eff, m_pad))
        qp = np.zeros((m_pad, q.shape[1]), np.float32)
        qp[:q_total] = q
        sid = np.full((m_pad,), -1, np.int32)
        if self_ids is not None:
            sid[:q_total] = self_ids
        b32 = np.zeros((m_pad, s_total), np.float32)
        b32[:q_total] = bounds
        fl = np.full((m_pad,), np.inf, np.float32)
        fl[:q_total] = floor
        cv = np.zeros((m_pad,), np.float32)
        cv[:q_total] = cover
        alive = np.zeros((m_pad,), bool)
        alive[:q_total] = True
        pool_d, pool_i, rr, radii, t_final = fab.fused_rounds(
            space, form, qp, sid, b32, fl, cv, alive,
            self._slot_gmaps(fab),
            seed=seed, growth=self._growth, k_eff=k_eff,
            self_mode=self_ids is not None, sentinel=n,
        )
        self._c["fused_dispatches"] += 1
        pool_d, pool_i, rr = (
            pool_d[:q_total], pool_i[:q_total], rr[:q_total]
        )
        # host-side round reconstruction, replaying the device's own
        # float32 visit compares (numpy f32 <= == device f32 <=, IEEE)
        rounds: list = []
        ever = np.zeros((q_total, s_total), bool)
        searches = 0
        total_tests = 0
        b32q = b32[:q_total]
        for t in range(t_final):
            r32 = np.float32(radii[t])
            unres_t = rr >= t  # the forced final round resolves every row
            visit_t = unres_t[:, None] & (b32q <= r32)
            ever |= visit_t
            searches += int(visit_t.sum())
            self._placed_load += visit_t.sum(axis=0)
            tests = int(m_pad) * n  # dense: every padded row, all slots
            total_tests += tests
            rounds.append(
                RoundStats(
                    t, float(r32), int(unres_t.sum()),
                    int((rr == t).sum()), tests, (), 0, 0.0,
                )
            )
        self._c["shard_rounds"] += t_final
        self._c["shard_searches"] += searches
        resolved_at = (
            np.where(
                rr >= 0,
                np.asarray(radii, np.float64)[
                    np.clip(rr, 0, max(t_final - 1, 0))
                ],
                np.nan,
            )
            if t_final
            else np.full((q_total,), np.nan)
        )
        if self_ids is not None:
            d, i = self._strip_self_knn(pool_d, pool_i, self_ids, k, n)
        else:
            d, i = pool_d[:, :k], pool_i[:, :k]
        self._update_seed(resolved_at, metric, ctx)
        out = KNNResult(
            dists=d,
            idxs=i,
            n_tests=total_tests,
            metric=metric.name,
            found=np.isfinite(d).sum(axis=1).astype(np.int64),
            rounds=rounds,
            final_radius=rounds[-1].radius if rounds else None,
        )
        out.timings["shard_searches"] = searches
        return self._account(
            q_total, int(ever.sum()), t0, out, dispatches=1
        )

    def execute_hybrid(self, queries, spec: HybridSpec, metric: Metric,
                       ctx=None):
        if self._use_placed(metric):
            return self._execute_hybrid_placed(queries, spec, metric, ctx)
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        q_total, n = q.shape[0], self.n_points
        k_eff = spec.k + (1 if self_ids is not None else 0)
        visit = shard_visit_mask(self._bounds(q, metric), spec.radius)
        parts, visits = [], 0
        for s in range(self.n_shards):
            sel = np.flatnonzero(visit[:, s])
            if not sel.size:
                continue
            k_child = min(k_eff, self._children[s].n_points)
            res = self._query_child(
                s, q[sel], HybridSpec(k_child, spec.radius), metric, ctx
            )
            parts.append(self._scatter_knn(res, sel, q_total, k_eff, s))
            visits += int(sel.size)
        if parts:
            out = merge_knn(
                parts, k_eff, sentinel=n, metric=metric.name
            )
        else:  # every shard pruned for every query: nothing in the ball
            out = KNNResult(
                dists=np.full((q_total, k_eff), np.inf, np.float32),
                idxs=np.full((q_total, k_eff), n, np.int32),
                n_tests=0,
                metric=metric.name,
            )
        if self_ids is not None:
            out.dists, out.idxs = self._strip_self_knn(
                out.dists, out.idxs, self_ids, spec.k, n
            )
        else:
            out.dists, out.idxs = out.dists[:, : spec.k], out.idxs[:, : spec.k]
        # HybridSpec's found contract (>= k iff resolved) with a concrete
        # meaning: how many in-ball neighbors the answer actually holds
        # (= min(k, ball population) — exactly the monolithic brute value).
        # Summed child founds are capped per shard and would overstate.
        out.found = np.isfinite(out.dists).sum(axis=1).astype(np.int64)
        return self._account(q_total, visits, t0, out)

    def _execute_hybrid_placed(self, queries, spec: HybridSpec,
                               metric: Metric, ctx=None):
        """Up-front radius cull, then ONE fused dispatch at k_eff for
        every surviving (row, shard) visit; the cut/map fold builds the
        same full-Q per-shard parts the host loop scatters, so the
        ``merge_knn`` answer is bit-identical."""
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        q_total, n = q.shape[0], self.n_points
        k_eff = spec.k + (1 if self_ids is not None else 0)
        fab = self._fabric()
        space, form = self._placed_route(metric, "hybrid")
        if space != "raw" and not fab.has_space(space):
            fab.add_space(space, metric.transform_points)
        tq = q if space == "raw" else metric.transform_points(q)
        visit = shard_visit_mask(self._bounds(q, metric), spec.radius)
        active = np.flatnonzero(visit.any(axis=1))
        parts, visits, dispatches = [], 0, 0
        if active.size:
            d_sl, i_sl, _cnt, m_pad = self._placed_dispatch(
                fab, space, form, tq, visit[active], active, k_eff, ctx,
                "hybrid",
            )
            dispatches = 1
            n_tests = int(m_pad) * n  # counted once, on the first part
            maps = self._slot_gmaps(fab)
            self._placed_load += visit.sum(axis=0)
            for s in range(self.n_shards):
                sel = np.flatnonzero(visit[:, s])
                if not sel.size:
                    continue
                pos = np.searchsorted(active, sel)
                d = np.full((q_total, k_eff), np.inf, np.float32)
                i = np.full((q_total, k_eff), n, np.int32)
                for j in fab.slots_of(s):
                    cd, keep = self._placed_cutmap(
                        metric, spec.radius, d_sl[j][pos]
                    )
                    ci = np.where(
                        keep, maps[j][i_sl[j][pos]], n
                    ).astype(np.int32)
                    d[sel], i[sel] = topk_merge_rows(
                        d[sel], i[sel], cd, ci, k_eff
                    )
                parts.append(
                    KNNResult(
                        dists=d, idxs=i, n_tests=n_tests, metric=metric.name
                    )
                )
                n_tests = 0
                visits += int(sel.size)
        if parts:
            out = merge_knn(parts, k_eff, sentinel=n, metric=metric.name)
        else:  # every shard pruned for every query: nothing in the ball
            out = KNNResult(
                dists=np.full((q_total, k_eff), np.inf, np.float32),
                idxs=np.full((q_total, k_eff), n, np.int32),
                n_tests=0,
                metric=metric.name,
            )
        if self_ids is not None:
            out.dists, out.idxs = self._strip_self_knn(
                out.dists, out.idxs, self_ids, spec.k, n
            )
        else:
            out.dists, out.idxs = out.dists[:, : spec.k], out.idxs[:, : spec.k]
        out.found = np.isfinite(out.dists).sum(axis=1).astype(np.int64)
        return self._account(
            q_total, visits, t0, out, dispatches=dispatches
        )

    def execute_range(self, queries, spec: RangeSpec, metric: Metric,
                      ctx=None):
        if self._use_placed(metric):
            return self._execute_range_placed(queries, spec, metric, ctx)
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        q_total = q.shape[0]
        m = spec.max_neighbors
        # the self match occupies one in-ball slot in its owning shard's
        # row; ask for one more so stripping it never loses a neighbor
        m_child = (m + 1) if (m is not None and self_ids is not None) else m
        visit = shard_visit_mask(self._bounds(q, metric), spec.radius)
        parts, visits = [], 0
        for s in range(self.n_shards):
            sel = np.flatnonzero(visit[:, s])
            if not sel.size:
                continue
            res = self._query_child(
                s, q[sel], RangeSpec(spec.radius, max_neighbors=m_child),
                metric, ctx,
            )
            part = self._scatter_range(res, sel, q_total, s)
            if self_ids is not None:
                part = self._strip_self_csr(part, self_ids)
            parts.append(part)
            visits += int(sel.size)
        if not parts:
            parts = [
                RangeResult(
                    offsets=np.zeros((q_total + 1,), np.int64),
                    idxs=np.empty((0,), np.int32),
                    dists=np.empty((0,), np.float32),
                    radius=spec.radius,
                    truncated=(
                        np.zeros((q_total,), bool) if m is not None else None
                    ),
                )
            ]
        out = merge_range(
            parts, radius=spec.radius, max_neighbors=m, metric=metric.name
        )
        return self._account(q_total, visits, t0, out)

    def _execute_range_placed(self, queries, spec: RangeSpec,
                              metric: Metric, ctx=None):
        """The counted-round range contract over the fabric: ONE fused
        dispatch returns per-slot top-k lists plus exact in-radius counts
        (the kernels' counter, computed against the identical f32
        threshold); if any (row, shard) ball needs more rows than the
        first k, exactly one escalated dispatch follows — at most 2 fused
        dispatches however many shards are visited, with per-shard takes,
        truncation flags and ``merge_range`` semantics identical to the
        host loop's ``range_from_counted_round`` children."""
        from ..planner import shard_visit_mask

        t0 = time.perf_counter()
        q, self_ids = self._prep(queries)
        q_total, n = q.shape[0], self.n_points
        m = spec.max_neighbors
        m_child = (m + 1) if (m is not None and self_ids is not None) else m
        fab = self._fabric()
        space, form = self._placed_route(metric, "range")
        if space != "raw" and not fab.has_space(space):
            fab.add_space(space, metric.transform_points)
        tq = q if space == "raw" else metric.transform_points(q)
        thr = self._placed_threshold(metric, spec.radius)
        visit = shard_visit_mask(self._bounds(q, metric), spec.radius)
        active = np.flatnonzero(visit.any(axis=1))
        parts, visits, dispatches = [], 0, 0
        if active.size:
            B = fab.block_rows
            k0 = min(max((m_child + 1) if m_child is not None else 32, 2), B)
            d_sl, i_sl, c_sl, m_pad = self._placed_dispatch(
                fab, space, form, tq, visit[active], active, k0, ctx,
                "range", threshold=thr,
            )
            dispatches = 1
            maps = self._slot_gmaps(fab)
            self._placed_load += visit.sum(axis=0)
            sizes = self._part.sizes
            # exact per-(row, shard) ball population: slot counts fold
            cnt = np.zeros((active.size, self.n_shards), np.int64)
            for j, (s, _lo, _hi) in enumerate(fab.slots):
                if s >= 0:
                    cnt[:, s] += c_sl[j]
            need = 0
            for s in range(self.n_shards):
                rows_s = visit[active, s]
                if not rows_s.any():
                    continue
                target = (
                    min(m_child, int(sizes[s]))
                    if m_child is not None
                    else int(sizes[s])
                )
                need = max(
                    need, int(np.minimum(cnt[rows_s, s], target).max())
                )
            if need > k0:
                d_sl, i_sl, c_sl, m_pad = self._placed_dispatch(
                    fab, space, form, tq, visit[active], active,
                    min(_next_pow2(need), B), ctx, "range", threshold=thr,
                )
                dispatches += 1
            K = d_sl.shape[2]
            n_tests = dispatches * int(m_pad) * n
            for s in range(self.n_shards):
                sel = np.flatnonzero(visit[:, s])
                if not sel.size:
                    continue
                pos = np.searchsorted(active, sel)
                n_s = int(sizes[s])
                target = min(m_child, n_s) if m_child is not None else n_s
                cs = cnt[pos, s]
                take = np.minimum(cs, target).astype(np.int64)
                # fold the shard's slot lists into one nearest-first row
                # set (cut applied first, so only in-ball rows survive)
                d = np.full((sel.size, K), np.inf, np.float32)
                i = np.full((sel.size, K), n, np.int32)
                for j in fab.slots_of(s):
                    cd, keep = self._placed_cutmap(
                        metric, spec.radius, d_sl[j][pos]
                    )
                    ci = np.where(
                        keep, maps[j][i_sl[j][pos]], n
                    ).astype(np.int32)
                    d, i = topk_merge_rows(d, i, cd, ci, K)
                keep_rows = np.arange(K)[None, :] < take[:, None]
                counts = np.zeros((q_total,), np.int64)
                counts[sel] = take
                offsets = np.zeros((q_total + 1,), np.int64)
                np.cumsum(counts, out=offsets[1:])
                truncated = None
                if m_child is not None:
                    truncated = np.zeros((q_total,), bool)
                    truncated[sel] = cs > target
                part = RangeResult(
                    offsets=offsets,
                    idxs=i[keep_rows].astype(np.int32),
                    dists=d[keep_rows].astype(np.float32),
                    radius=spec.radius,
                    n_tests=n_tests,
                    metric=metric.name,
                    truncated=truncated,
                )
                n_tests = 0
                if self_ids is not None:
                    part = self._strip_self_csr(part, self_ids)
                parts.append(part)
                visits += int(sel.size)
        if not parts:
            parts = [
                RangeResult(
                    offsets=np.zeros((q_total + 1,), np.int64),
                    idxs=np.empty((0,), np.int32),
                    dists=np.empty((0,), np.float32),
                    radius=spec.radius,
                    truncated=(
                        np.zeros((q_total,), bool) if m is not None else None
                    ),
                )
            ]
        out = merge_range(
            parts, radius=spec.radius, max_neighbors=m, metric=metric.name
        )
        return self._account(
            q_total, visits, t0, out, dispatches=dispatches
        )

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        s = super().stats()
        s.update(self._c)
        potential = self._c["shard_visits"] + self._c["shard_visits_pruned"]
        s.update(
            n_shards=self.n_shards,
            partition=self._part.method,
            child_backend=self._child_backend,
            shard_sizes=self._part.sizes.tolist(),
            warm_seed=dict(self._warm_seed),
            prune_rate=(
                round(self._c["shard_visits_pruned"] / potential, 4)
                if potential
                else 0.0
            ),
            children=[c.stats() for c in self._children],
        )
        s["placement"] = self._placement_stats()
        return s

    def _placement_stats(self) -> dict:
        if self._placement != "devices":
            return {"mode": "host"}
        fab = self._placed
        if fab is None:
            # projected layout: the fabric materializes on the first
            # placed dispatch, but occupancy is already decided by the
            # partition, so report it without placing anything
            devs = int(self._mesh.devices.size)
            n_slots = -(-self.n_shards // devs) * devs
            slot_shard = np.full((n_slots,), -1, np.int64)
            slot_shard[: self.n_shards] = np.arange(self.n_shards)
            return {
                "mode": "devices",
                "devices": devs,
                "slots": n_slots,
                "materialized": False,
                "fused_dispatches": 0,
                "rebalances": 0,
                "device_occupancy": shard_occupancy(
                    self._part.sizes, slot_shard, devs
                ),
            }
        return {
            "mode": "devices",
            "devices": fab.n_devices,
            "slots": fab.n_slots,
            "block_rows": fab.block_rows,
            "materialized": True,
            "fused_dispatches": int(fab.dispatches),
            "rebalances": int(fab.rebalances),
            "device_occupancy": fab.occupancy(),
        }
