"""MutableIndex (port of ``repro.api.backends.mutable``) — streaming
inserts/deletes over a resident index.  ``backend="mutable"``.

Every other backend in this repo is *build-once*: the paper's workload
amortizes one expensive structure over many query batches, and nothing in
a BVH/grid build survives a changed point cloud.  This backend makes the
resident handle *writable* without giving up that amortization, using the
LSM (log-structured merge) shape databases use for the same problem:

* **Base index** — an immutable index of any registered backend
  (``base_backend``, default "trueknn") over the bulk of the cloud.  All
  the heavy build cost lives here and is paid rarely.
* **Delta shards** — inserts land in a small append-only open buffer;
  when it reaches ``delta_rows`` it is *sealed* into an immutable brute
  delta shard.  Brute is the right delta engine: sealing is free (pinning
  rows), shards stay small, and the dense engine is exact for every
  registered metric.
* **Tombstones** — deletes never touch any structure; the deleted id
  joins a tombstone set that masks it out of every answer.
* **Compaction** — when the deltas or tombstones outgrow the base
  (:class:`repro_torch.api.mutable.CompactionPolicy`), the base is rebuilt from
  the live rows and the consumed deltas/tombstones are retired.  Inline
  by default; ``auto_compact="background"`` rebuilds on a thread while
  queries keep answering from the pre-compaction snapshot.  On the card
  the rebuild's kernels launch from that thread, which waits for the
  device (``torch.cuda.synchronize``) before it publishes the new base.

The base, every delta shard's brute engine and the ``stop_radius``
companion live on the index's ``device``: the base's kernels (``grid_round``
for a trueknn base) and the deltas' ``pairwise_topk`` launch on the card.

**Stable ids.**  Results are reported in a *stable id* space: the initial
rows get ids ``0..N-1``, every insert mints the next ids, and deletion
never renumbers anything.  ``sentinel`` is therefore ``next_id`` (one past
the largest id ever minted), not ``n_points``.  Because ids mint
monotonically and base rows always precede delta rows, ascending stable
id == ascending live position — so the merge's tie-breaking (ascending
index at equal distance) agrees with a monolithic rebuild of the live
rows, and answers stay bit-identical to that rebuild under the id map.

**Exactness.**  A query fans out over base + sealed shards + open buffer
through the tombstone-aware folds in ``repro_torch.core.result``:

* each source is over-fetched by the *total* tombstone count ``T``
  (``k_src = min(k_eff + T, n_src)``; range rows by ``m + T`` (+1 on
  self-query)) — the i-th nearest live candidate of a source has source
  rank at most ``i + T``, so masking tombstones BEFORE the top-k / row
  cap truncation provably loses nothing;
* ``merge_knn`` / ``merge_range`` fold the per-source parts with the
  tombstone mask applied first, so found/truncated/CSR semantics match
  the monolithic rebuild exactly.

``KnnSpec.stop_radius`` has radius-*schedule* semantics no fan-out can
reproduce (one schedule over the whole cloud), so it is answered by a
per-generation companion trueknn index over the live snapshot, with its
positional answer mapped back into stable-id space.

cfg:
  base_backend:   registry name of the base engine (default "trueknn";
                  anything registered except "mutable" itself).
  base_cfg:       cfg dict forwarded to the base's ``build_index``.
  delta_rows:     open-buffer rows before sealing a delta shard (2048).
  compact_min_rows / compact_ratio / tombstone_ratio / auto_compact:
                  compaction policy — see
                  :class:`repro_torch.api.mutable.CompactionPolicy`.
  device:         "cuda" (default) or "cpu"; the base's, the deltas' and
                  the companion's too (a ``device`` in ``base_cfg`` is
                  overridden).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from ...core.result import (
    KNNResult,
    RangeResult,
    merge_knn,
    merge_range,
    strip_self_csr,
    strip_self_knn,
)

from ..index import NeighborIndex, build_index
from ..metrics import Metric
from ..query import HybridSpec, KnnSpec, RangeSpec
from ..registry import register_backend

__all__ = ["MutableIndex"]


class _DeltaShard:
    """One sealed, immutable write-absorbing shard: pinned rows + their
    stable ids + a lazily-built brute engine over them on ``device``."""

    __slots__ = ("pts", "ids", "device", "_index")

    def __init__(self, pts: np.ndarray, ids: np.ndarray, device):
        self.pts = np.ascontiguousarray(pts, np.float32)
        self.ids = np.ascontiguousarray(ids, np.int64)
        self.device = device
        self._index = None

    @property
    def n_rows(self) -> int:
        return self.pts.shape[0]

    def index(self):
        # idempotent lazy build; racing builders produce equivalent engines
        idx = self._index
        if idx is None:
            idx = build_index(self.pts, backend="brute", device=self.device)
            self._index = idx
        return idx


@dataclasses.dataclass(frozen=True)
class _Source:
    """One immutable query source of a snapshot."""

    index: object  # NeighborIndex
    ids: np.ndarray  # (n_src,) int64 stable ids, ascending
    gmap: np.ndarray  # (n_src + 1,) int32: local idx -> stable id, + sentinel
    is_base: bool


@dataclasses.dataclass(frozen=True)
class _Snapshot:
    """A consistent read view: query it lock-free while writers proceed."""

    sources: tuple  # of _Source, base first then deltas in id order
    tombs: np.ndarray  # (T,) int64 sorted tombstoned ids
    sentinel: int  # next_id at snapshot time

    def live(self):
        """(pts, ids) of the live rows, ascending stable id."""
        ps, iss = [], []
        for s in self.sources:
            alive = ~np.isin(s.ids, self.tombs) if self.tombs.size else None
            if alive is None:
                ps.append(s.index.points)
                iss.append(s.ids)
            else:
                ps.append(s.index.points[alive])
                iss.append(s.ids[alive])
        if not ps:
            return np.empty((0, 0), np.float32), np.empty((0,), np.int64)
        return np.concatenate(ps), np.concatenate(iss)


@register_backend("mutable")
class MutableIndex(NeighborIndex):
    """LSM composite: immutable base + brute delta shards + tombstones."""

    native_metrics = frozenset({"l2", "l1", "linf", "cosine"})

    def __init__(
        self,
        points,
        *,
        base_backend: str = "trueknn",
        base_cfg: Optional[dict] = None,
        delta_rows: int = 2048,
        compact_min_rows: int = 4096,
        compact_ratio: float = 0.5,
        tombstone_ratio: float = 0.2,
        auto_compact: str = "inline",
        device="cuda",
    ):
        from ..mutable import CompactionPolicy

        super().__init__(points, device)
        if base_backend == "mutable":
            raise ValueError(
                "a mutable base of a mutable index is not supported; pick "
                "an immutable base backend (trueknn / brute / sharded / ...)"
            )
        self._base_backend = base_backend
        self._base_cfg = dict(base_cfg or {})
        self._delta_rows = int(delta_rows)
        if self._delta_rows < 1:
            raise ValueError("delta_rows must be positive")
        self._policy = CompactionPolicy(
            min_rows=int(compact_min_rows),
            ratio=float(compact_ratio),
            tombstone_ratio=float(tombstone_ratio),
            mode=str(auto_compact),
        )
        self._dim = self._pts.shape[1]
        self._mu = threading.RLock()
        self._base = self._build_base(self._pts)
        self._base_ids = np.arange(self._pts.shape[0], dtype=np.int64)
        self._next_id = self._pts.shape[0]
        self._id_set = set(range(self._pts.shape[0]))  # live ids
        self._sealed: list = []  # of _DeltaShard, in creation (id) order
        self._open_pts: list = []  # of (m, d) float32 chunks
        self._open_ids: list = []  # of (m,) int64 chunks
        self._open_n = 0
        self._open_shard: Optional[_DeltaShard] = None  # materialized view
        self._tombs: set = set()
        self._tombs_arr: Optional[np.ndarray] = None
        # knn-with-stop_radius companion over the live snapshot, rebuilt
        # per generation (the only spec variant a fan-out cannot serve)
        self._companion: Optional[tuple] = None  # (generation, index, gmap)
        self._bg: Optional[threading.Thread] = None
        self._compacting = False
        #: test seam: called with the index after a compaction's new base
        #: is built but BEFORE the swap — lets tests freeze a compaction
        #: mid-flight and assert queries still answer exactly
        self._on_compact_built = None
        self._c = {
            "inserts": 0,
            "deletes": 0,
            "compactions": 0,
            "seals": 0,
            "queries_served": 0,
        }
        # KnnSpec.start_radius keeps the BASE backend's meaning ("seed" =
        # scheduling hint, "bound" = hard cap); deltas follow suit in
        # _source_knn_spec so the composite answer has ONE semantics
        self.knn_start_radius_semantics = self._base.knn_start_radius_semantics

    def _build_base(self, pts: np.ndarray):
        """An immutable base over ``pts`` on this index's device."""
        return build_index(pts, backend=self._base_backend,
                           **dict(self._base_cfg, device=self._device))

    def _adopt(self, base) -> None:
        """Install an already-built immutable index as the base of a
        freshly-constructed *empty* MutableIndex (no rebuild — the
        resident structure and its warm state carry over; its rows become
        stable ids ``0..N-1``).  Used by
        ``repro_torch.api.mutable.make_mutable``."""
        if base.backend_name == "mutable":
            raise ValueError("cannot adopt a mutable index as a base")
        if base.device != self._device:
            raise ValueError(
                f"the base lives on {base.device}, this index on "
                f"{self._device}"
            )
        with self._mu:
            if self._next_id or self._sealed or self._open_n:
                raise ValueError("adopt requires a fresh, empty MutableIndex")
            n = base.n_points
            self._base = base
            self._base_ids = np.arange(n, dtype=np.int64)
            self._next_id = n
            self._id_set = set(range(n))
            self._dim = base.dim

    # -- live-cloud introspection (stable-id space) ------------------------

    @property
    def points(self) -> np.ndarray:
        """Live rows, ascending stable id (materialized per call)."""
        return self._snapshot().live()[0]

    @property
    def n_points(self) -> int:
        with self._mu:
            return len(self._id_set)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def sentinel(self) -> int:
        """One past the largest id ever minted — the padding id of every
        answer.  Stable ids survive deletion, so this is ``next_id``, not
        the live count."""
        with self._mu:
            return self._next_id

    def snapshot(self):
        """(live_pts, live_ids) at a consistent instant — the logical
        cloud a monolithic rebuild would be built from (tests and the
        mutation benchmark compare answers against exactly this)."""
        return self._snapshot().live()

    def stats(self) -> dict:
        with self._mu:
            s = {
                "backend": self.backend_name,
                "n_points": len(self._id_set),
                "dim": self._dim,
                "generation": self._generation,
                "metric_views": sorted(self._metric_views),
                "base_backend": self._base_backend,
                "base_rows": int(self._base_ids.size),
                "delta_shards": len(self._sealed),
                "delta_rows": int(
                    sum(sh.n_rows for sh in self._sealed) + self._open_n
                ),
                "open_rows": self._open_n,
                "tombstones": len(self._tombs),
                "next_id": self._next_id,
                "auto_compact": self._policy.mode,
                "compacting": self._compacting,
                "device": str(self._device),
            }
            s.update(self._c)
            bp = self._base.stats().get("placement")
            if isinstance(bp, dict) and bp.get("mode") == "devices":
                # surface the placed base's occupancy/dispatch section so
                # serving meters see through the LSM composite
                s["placement"] = bp
            return s

    # -- mutation ----------------------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Append rows to the live cloud; returns their minted stable ids
        ((m,) int64).  Rows land in the open buffer (absorbing writes at
        memcpy cost), seal into a brute delta shard at ``delta_rows``, and
        are retired into the base by the next compaction."""
        pts = np.asarray(points, np.float32)
        if pts.ndim == 1:
            pts = pts[None, :]
        if pts.ndim != 2 or pts.shape[1] != self._dim:
            raise ValueError(
                f"insert rows must be (m, {self._dim}) or ({self._dim},), "
                f"got {pts.shape}"
            )
        m = pts.shape[0]
        if m == 0:
            return np.empty((0,), np.int64)
        with self._mu:
            ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
            self._next_id += m
            self._open_pts.append(pts.copy())
            self._open_ids.append(ids)
            self._open_n += m
            self._id_set.update(ids.tolist())
            self._open_shard = None  # stale materialized view
            if self._open_n >= self._delta_rows:
                self._seal_open()
            self._c["inserts"] += m
            self._generation += 1
        self._maybe_compact()
        return ids

    def delete(self, ids) -> int:
        """Tombstone live rows by stable id; returns how many were
        deleted.  Unknown or already-deleted ids raise ``KeyError``
        (silently ignoring them would hide double-delete bugs).  The rows
        physically leave the structures at the next compaction."""
        arr = np.unique(np.asarray(ids, np.int64).ravel())
        if arr.size == 0:
            return 0
        with self._mu:
            for i in arr.tolist():
                if i not in self._id_set:
                    raise KeyError(
                        f"id {i} is not a live dataset id (never minted, "
                        "or already deleted)"
                    )
            for i in arr.tolist():
                self._id_set.discard(i)
                self._tombs.add(i)
            self._tombs_arr = None
            self._c["deletes"] += int(arr.size)
            self._generation += 1
        self._maybe_compact()
        return int(arr.size)

    # -- compaction --------------------------------------------------------

    def _seal_open(self) -> None:
        """Freeze the open buffer into an immutable delta shard (caller
        holds the lock)."""
        if self._open_n == 0:
            return
        self._sealed.append(
            _DeltaShard(
                np.concatenate(self._open_pts),
                np.concatenate(self._open_ids),
                self._device,
            )
        )
        self._open_pts, self._open_ids, self._open_n = [], [], 0
        self._open_shard = None
        self._c["seals"] += 1

    def compaction_due(self) -> bool:
        with self._mu:
            delta = sum(sh.n_rows for sh in self._sealed) + self._open_n
            return self._policy.due(
                int(self._base_ids.size), delta, len(self._tombs)
            )

    def _maybe_compact(self) -> None:
        mode = self._policy.mode
        if mode == "off" or not self.compaction_due():
            return
        if mode == "inline":
            self.compact()
            return
        with self._mu:  # background: one rebuild in flight at a time
            if self._compacting or (self._bg is not None and self._bg.is_alive()):
                return
            t = threading.Thread(
                target=self.compact, name="MutableIndex.compact", daemon=True
            )
            self._bg = t
            t.start()

    def compact(self) -> bool:
        """Rebuild the base from the live rows and retire the consumed
        deltas/tombstones.  Returns False when a compaction is already in
        flight.  The open buffer is sealed first, so the rebuild consumes
        a frozen prefix of the log: inserts racing the rebuild land in a
        NEW open buffer and survive the swap untouched, and tombstones on
        unconsumed rows stay in the set (only tombstones on consumed ids
        are retired).  Queries keep answering from the pre-swap snapshot
        throughout; the swap bumps ``generation`` so prepared plans
        re-prepare."""
        with self._mu:
            if self._compacting:
                return False
            self._compacting = True
            self._seal_open()
            consumed = list(self._sealed)
            sealed_upto = len(consumed)
            base, base_ids = self._base, self._base_ids
            tombs = np.asarray(sorted(self._tombs), np.int64)
        try:
            pts_all = np.concatenate(
                [base.points] + [sh.pts for sh in consumed]
            )
            ids_all = np.concatenate([base_ids] + [sh.ids for sh in consumed])
            dead = (
                np.isin(ids_all, tombs)
                if tombs.size
                else np.zeros((ids_all.size,), bool)
            )
            applied = set(ids_all[dead].tolist())
            new_base = self._build_base(np.ascontiguousarray(pts_all[~dead]))
            if self._device.type == "cuda":
                # the rebuild's kernels may still run (on this thread's
                # stream): the new base is complete before it is published
                torch.cuda.synchronize(self._device)
            new_ids = ids_all[~dead]
            hook = self._on_compact_built
            if hook is not None:
                hook(self)
            with self._mu:
                self._base = new_base
                self._base_ids = new_ids
                del self._sealed[:sealed_upto]
                self._tombs -= applied
                self._tombs_arr = None
                self._c["compactions"] += 1
                self._generation += 1
            return True
        finally:
            with self._mu:
                self._compacting = False

    # -- snapshots ---------------------------------------------------------

    def _gmap_of(self, ids: np.ndarray, sentinel: int) -> np.ndarray:
        g = np.empty((ids.size + 1,), np.int32)
        g[:-1] = ids
        g[-1] = sentinel
        return g

    def _snapshot(self) -> _Snapshot:
        with self._mu:
            sentinel = self._next_id
            sources = []
            if self._base.n_points:
                sources.append(
                    _Source(
                        self._base,
                        self._base_ids,
                        self._gmap_of(self._base_ids, sentinel),
                        True,
                    )
                )
            shards = list(self._sealed)
            if self._open_n:
                if self._open_shard is None:
                    self._open_shard = _DeltaShard(
                        np.concatenate(self._open_pts),
                        np.concatenate(self._open_ids),
                        self._device,
                    )
                shards.append(self._open_shard)
            for sh in shards:
                sources.append(
                    _Source(
                        sh.index(),
                        sh.ids,
                        self._gmap_of(sh.ids, sentinel),
                        False,
                    )
                )
            if self._tombs_arr is None:
                self._tombs_arr = np.asarray(sorted(self._tombs), np.int64)
            return _Snapshot(tuple(sources), self._tombs_arr, sentinel)

    # -- planner contract --------------------------------------------------

    def supports_knn_spec(self, spec: KnnSpec) -> bool:
        # every variant is handled natively — stop_radius through the
        # live-snapshot companion (the planner's generic knn_fallback
        # would answer in POSITIONAL id space, corrupting stable ids)
        return True

    def plan_details(self, spec, metric: Metric) -> tuple:
        with self._mu:
            props = {
                "base_backend": self._base_backend,
                "base_rows": int(self._base_ids.size),
                "delta_shards": len(self._sealed) + (1 if self._open_n else 0),
                "tombstones": len(self._tombs),
                "auto_compact": self._policy.mode,
            }

        def children():  # built on first explain()
            from ..planner import build_plan

            snap = self._snapshot()
            nodes = []
            for src in snap.sources:
                node = build_plan(src.index, spec, metric.name)
                node.props = dict(
                    node.props,
                    source="base" if src.is_base else "delta",
                    source_rows=int(src.ids.size),
                )
                nodes.append(node)
            return nodes

        return "mutable", props, children

    # -- query fan-out -----------------------------------------------------

    def _prep(self, queries, snap: _Snapshot):
        """(rows, self_ids): explicit rows, or the live snapshot querying
        itself (self matches stripped after the merge — the sharded
        fabric's idiom, over stable ids here)."""
        if queries is None:
            pts, ids = snap.live()
            return pts, ids
        return np.asarray(queries, np.float32), None

    def _source_part(self, src: _Source, rows, spec, metric: Metric, ctx):
        """Query one source and lift its answer into stable-id space.
        Child ``found`` values are source-capped counts that do not
        partition a global count, so they are dropped here (the composite
        derives its own after the merge)."""
        from ..planner import execute

        res = execute(src.index, rows, spec, metric.name, ctx)
        if isinstance(res, RangeResult):
            return dataclasses.replace(
                res, idxs=src.gmap[np.asarray(res.idxs)]
            )
        return KNNResult(
            dists=np.asarray(res.dists),
            idxs=src.gmap[np.asarray(res.idxs)],
            n_tests=int(res.n_tests),
            backend=res.backend,
            metric=res.metric,
            rounds=res.rounds,
        )

    def _source_knn_spec(self, src: _Source, k_src: int, spec: KnnSpec):
        """Per-source KnnSpec keeping ONE start_radius semantics: under
        "bound" every source applies the same hard cap (brute deltas and a
        bound base agree); under "seed" the radius is a scheduling hint
        for the base's rounds only — handing it to a brute delta would
        BOUND that part and break exactness, so deltas get none."""
        if spec.start_radius is None:
            return KnnSpec(k_src)
        if self.knn_start_radius_semantics == "bound":
            return KnnSpec(k_src, start_radius=spec.start_radius)
        if src.is_base:
            return KnnSpec(k_src, start_radius=spec.start_radius)
        return KnnSpec(k_src)

    def _merge_fanout(self, snap, parts, k_eff, k, self_ids, metric, *,
                      cut_applied: bool):
        """Tombstone-aware fold + self strip + composite ``found``."""
        tombs = snap.tombs if snap.tombs.size else None
        out = merge_knn(
            parts, k_eff, sentinel=snap.sentinel, metric=metric.name,
            tombstones=tombs,
        )
        if self_ids is not None:
            out.dists, out.idxs = strip_self_knn(
                out.dists, out.idxs, self_ids, k, snap.sentinel
            )
        else:
            out.dists, out.idxs = out.dists[:, :k], out.idxs[:, :k]
        # radius-capped answers report how many in-radius live neighbors
        # they hold (= min(k, live ball) — the monolithic brute value);
        # unbounded knn matches the monolith's found=None
        out.found = (
            np.isfinite(out.dists).sum(axis=1).astype(np.int64)
            if cut_applied
            else None
        )
        return out

    def _finish(self, res, q_total: int, t0: float, n_sources: int):
        res.backend = self.backend_name
        res.timings.update(
            plan=f"mutable/sources={n_sources}",
            query_seconds=time.perf_counter() - t0,
        )
        with self._mu:
            self._c["queries_served"] += q_total
        return res

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        if spec.stop_radius is not None:
            return self._knn_companion(queries, spec, metric, ctx)
        t0 = time.perf_counter()
        snap = self._snapshot()
        q, self_ids = self._prep(queries, snap)
        k = spec.k
        k_eff = k + (1 if self_ids is not None else 0)
        T = int(snap.tombs.size)
        parts = []
        for src in snap.sources:
            k_src = min(k_eff + T, src.index.n_points)
            parts.append(
                self._source_part(
                    src, q, self._source_knn_spec(src, k_src, spec),
                    metric, ctx,
                )
            )
        if not parts:
            from ..planner import empty_result

            return empty_result(self, spec, metric.name, q_total=q.shape[0])
        bound = (
            spec.start_radius is not None
            and self.knn_start_radius_semantics == "bound"
        )
        out = self._merge_fanout(
            snap, parts, k_eff, k, self_ids, metric, cut_applied=bound
        )
        return self._finish(out, q.shape[0], t0, len(parts))

    def execute_hybrid(self, queries, spec: HybridSpec, metric: Metric,
                       ctx=None) -> KNNResult:
        t0 = time.perf_counter()
        snap = self._snapshot()
        q, self_ids = self._prep(queries, snap)
        k = spec.k
        k_eff = k + (1 if self_ids is not None else 0)
        T = int(snap.tombs.size)
        parts = []
        for src in snap.sources:
            k_src = min(k_eff + T, src.index.n_points)
            parts.append(
                self._source_part(
                    src, q, HybridSpec(k_src, spec.radius), metric, ctx
                )
            )
        if not parts:
            from ..planner import empty_result

            return empty_result(self, spec, metric.name, q_total=q.shape[0])
        out = self._merge_fanout(
            snap, parts, k_eff, k, self_ids, metric, cut_applied=True
        )
        return self._finish(out, q.shape[0], t0, len(parts))

    def execute_range(self, queries, spec: RangeSpec, metric: Metric,
                      ctx=None) -> RangeResult:
        t0 = time.perf_counter()
        snap = self._snapshot()
        q, self_ids = self._prep(queries, snap)
        q_total = q.shape[0]
        T = int(snap.tombs.size)
        m = spec.max_neighbors
        # over-fetch each source's row cap by the tombstone count (and one
        # self slot): after the pre-truncation mask, the nearest m live
        # rows provably survive and per-part truncated flags stay exact
        m_child = (
            m + T + (1 if self_ids is not None else 0)
            if m is not None
            else None
        )
        parts = []
        for src in snap.sources:
            part = self._source_part(
                src, q, RangeSpec(spec.radius, max_neighbors=m_child),
                metric, ctx,
            )
            if self_ids is not None:
                part = strip_self_csr(part, self_ids)
            parts.append(part)
        if not parts:
            from ..planner import empty_result

            return empty_result(self, spec, metric.name, q_total=q_total)
        out = merge_range(
            parts, radius=spec.radius, max_neighbors=m, metric=metric.name,
            tombstones=snap.tombs if T else None,
        )
        return self._finish(out, q_total, t0, len(parts))

    # -- stop_radius companion ---------------------------------------------

    def _knn_companion(self, queries, spec: KnnSpec, metric: Metric, ctx):
        """``stop_radius`` answers: one radius schedule over the whole
        live cloud (per-source schedules diverge, so no fan-out is
        faithful).  A trueknn companion over the live snapshot — cached
        per generation — answers positionally; the answer is mapped back
        into stable-id space."""
        from ..planner import execute

        t0 = time.perf_counter()
        with self._mu:
            gen = self._generation
            comp = self._companion
        if comp is None or comp[0] != gen:
            pts, ids = self.snapshot()
            from .trueknn import TrueKNNIndex

            comp = (gen, TrueKNNIndex(pts, device=self._device),
                    self._gmap_of(ids, self.sentinel))
            with self._mu:
                self._companion = comp
        _, view, gmap = comp
        res = execute(view, queries, spec, metric.name, ctx)
        res.idxs = gmap[np.asarray(res.idxs)]
        res.backend = self.backend_name
        res.timings["plan"] = "mutable/companion"
        res.timings["query_seconds"] = time.perf_counter() - t0
        with self._mu:
            self._c["queries_served"] += (
                view.n_points if queries is None
                else np.asarray(queries).shape[0]
            )
        return res
