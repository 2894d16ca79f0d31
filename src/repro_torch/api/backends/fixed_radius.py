"""Fixed-radius backend (paper Alg. 1) — ``backend="fixed_radius"`` (port
of ``repro.api.backends.fixed_radius``).

The hash grid for a given radius is built on first use and cached on the
index (a per-radius LRU), so serving many batches at the same radius pays
binning once.

One grid round returns the k best *within the ball* plus the exact
in-ball count, so hybrid is a single round and range is at most two (the
second sized by the counts).  ``KnnSpec`` needs a radius (cfg default or
``start_radius``) and answers with fixed-radius semantics — it cannot grow
the ball; use the trueknn backend for unbounded search.

On the card every round is one launch of the ``grid_round`` CUDA kernel;
on the CPU its plain version runs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ...core.fixed_radius import fixed_radius_round
from ...core.grid import build_grid
from ...core.result import KNNResult, RoundStats
from ...kernels.ops import sqrt32
from ..index import NeighborIndex
from ..metrics import Metric
from ..query import HybridSpec, KnnSpec, RangeSpec
from ..registry import register_backend

__all__ = ["FixedRadiusIndex"]


@register_backend("fixed_radius")
class FixedRadiusIndex(NeighborIndex):
    """Single-round search within an exact radius ball.

    cfg: ``radius`` (default search radius; specs carrying their own radius
    override per call), ``chunk`` (query rows per step of the plain (CPU)
    grid round, default 2048; the CUDA kernel takes every row at once),
    ``max_cached_grids`` (LRU bound on per-radius grids so per-request
    radii can't grow device memory without limit; default 16), ``device``
    ("cuda" or "cpu").
    """

    radius_cfg_keys = ("radius",)  # metric-space: mapped for metric views
    knn_start_radius_semantics = "bound"  # KnnSpec searches exactly this ball

    def __init__(self, points, *, radius: Optional[float] = None,
                 chunk: int = 2048, max_cached_grids: int = 16,
                 device="cuda"):
        super().__init__(points, device)
        self._default_radius = radius
        self._chunk = int(chunk)
        self._max_cached_grids = max(1, int(max_cached_grids))
        self._grids: dict = {}  # radius -> Grid (insertion-ordered LRU)
        self._grid_builds = 0
        self._grid_cache_hits = 0

    def _grid_for(self, radius: float):
        key = float(radius)
        g = self._grids.pop(key, None)
        if g is not None:
            self._grids[key] = g  # refresh recency
            self._grid_cache_hits += 1
            return g, True
        g = build_grid(self._pts, radius, device_points=self._pts_t)
        self._grids[key] = g
        self._grid_builds += 1
        while len(self._grids) > self._max_cached_grids:
            self._grids.pop(next(iter(self._grids)))
        return g, False

    def _queries_and_ids(self, queries):
        """(query block, ids): a self-query hands the kernel the resident
        device buffer, an external batch its host array."""
        if queries is None:
            return self._pts_t, np.arange(self.n_points, dtype=np.int32)
        q = np.asarray(queries, np.float32)
        return q, np.full((q.shape[0],), self.n_points, np.int32)

    def _round(self, q, qid, grid, r: float, k: int):
        """One counted round: (dists, idxs, found) on the host, n_tests."""
        d2, idx, found, n_tests = fixed_radius_round(
            self._pts_t, grid, q, qid, r, int(k), chunk=self._chunk
        )
        return (sqrt32(d2).cpu().numpy(), idx.cpu().numpy(),
                found.cpu().numpy(), n_tests)

    def _one_round(self, queries, k: int, r: float,
                   metric: Metric) -> KNNResult:
        r = float(r)
        t0 = time.perf_counter()
        q, qid = self._queries_and_ids(queries)
        grid, hit = self._grid_for(r)
        t_grid = time.perf_counter() - t0
        dists, idxs, found, n_tests = self._round(q, qid, grid, r, k)
        dt = time.perf_counter() - t0
        return KNNResult(
            dists=dists,
            idxs=idxs,
            n_tests=int(n_tests),
            backend=self.backend_name,
            metric=metric.name,
            found=found,
            rounds=[RoundStats(0, r, q.shape[0], int((found >= k).sum()),
                               int(n_tests), grid.res, grid.cap, dt,
                               cache_hit=hit)],
            timings={
                "query_seconds": dt,
                "grid_build_seconds": 0.0 if hit else t_grid,
                "grid_builds": 0 if hit else 1,
                "grid_cache_hits": 1 if hit else 0,
            },
            start_radius=r,
            final_radius=r,
        )

    def knn_spec_radius_cut(self, spec: KnnSpec):
        # KnnSpec searches exactly one ball here: the spec's radius or the
        # cfg default.  Generic metric plans apply the same bound so the
        # spec means one thing on this backend under every metric.
        r = (
            spec.start_radius
            if spec.start_radius is not None
            else self._default_radius
        )
        if r is None:
            raise ValueError(
                "fixed_radius backend needs a radius — pass "
                "build_index(..., radius=r), KnnSpec(k, start_radius=r) or "
                "HybridSpec(k, r)"
            )
        return float(r)

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        if spec.stop_radius is not None:
            raise ValueError("fixed_radius backend searches one radius; "
                             "use backend='trueknn' for stop_radius")
        return self._one_round(
            queries, spec.k, self.knn_spec_radius_cut(spec), metric
        )

    def execute_hybrid(self, queries, spec: HybridSpec, metric: Metric,
                       ctx=None):
        # hybrid IS this backend's native shape: k best within the ball
        return self._one_round(queries, spec.k, spec.radius, metric)

    def execute_range(self, queries, spec: RangeSpec, metric: Metric,
                      ctx=None):
        from ..planner import range_from_counted_round

        r = float(spec.radius)
        q, qid = self._queries_and_ids(queries)
        grid, hit = self._grid_for(r)
        return range_from_counted_round(
            lambda k: self._round(q, qid, grid, r, k),
            q_total=q.shape[0],
            cap=self.n_points - (1 if queries is None else 0),
            spec=spec,
            backend=self.backend_name,
            timings_extra={
                "plan": "native",
                "grid_builds": 0 if hit else 1,
                "grid_cache_hits": 1 if hit else 0,
            },
        )

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            grid_builds=self._grid_builds,
            grid_cache_hits=self._grid_cache_hits,
            cached_grids=len(self._grids),
        )
        return s
