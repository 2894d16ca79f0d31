"""Brute-force backend — the exact oracle behind ``backend="brute"`` (port
of ``repro.api.backends.brute``).

kNN and hybrid run the exact brute engine; range runs the
``pairwise_topk`` kernel's in-radius counter (exact ball populations, so a
range answer costs at most two kernel passes).  Every registered metric
is native here.
"""

from __future__ import annotations

import time

from ...core.brute import brute_knn_engine
from ...core.result import KNNResult
from ..index import NeighborIndex
from ..metrics import Metric
from ..query import HybridSpec, KnnSpec, RangeSpec
from ..registry import register_backend

__all__ = ["BruteIndex"]


@register_backend("brute")
class BruteIndex(NeighborIndex):
    """Exact kNN by dense distances.

    cfg: ``chunk`` (query rows per distance block of the plain CPU engine,
    default 512), ``device`` ("cuda" or "cpu").
    """

    native_metrics = frozenset({"l2", "l1", "linf", "cosine"})
    knn_start_radius_semantics = "bound"  # no schedule: it's a post-filter

    def __init__(self, points, *, chunk: int = 512, device="cuda"):
        super().__init__(points, device)
        self._chunk = int(chunk)
        self._queries_served = 0

    def _knn(self, queries, k: int, metric: Metric, *, cut=None):
        t0 = time.perf_counter()
        d, i, n_tests = brute_knn_engine(
            self._pts_t, k, queries=queries, chunk=self._chunk,
            metric=metric.kernel_name,
        )
        dists = d.cpu().numpy()
        idxs = i.cpu().numpy()
        found = None
        if cut is not None:
            # radius cap: drop beyond-radius hits; ``found`` counts the
            # in-radius neighbors among the k returned
            from ..planner import apply_radius_cut

            dists, idxs, found = apply_radius_cut(
                dists, idxs, cut, self.n_points
            )
        self._queries_served += dists.shape[0]
        return KNNResult(
            dists=dists,
            idxs=idxs,
            n_tests=int(n_tests),
            backend=self.backend_name,
            metric=metric.name,
            found=found,
            timings={"query_seconds": time.perf_counter() - t0},
        )

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        if spec.stop_radius is not None:
            raise ValueError("brute backend has no radius schedule; "
                             "stop_radius is not meaningful here")
        # start_radius on a schedule-free engine: convenience post-filter
        return self._knn(queries, spec.k, metric, cut=spec.start_radius)

    def execute_hybrid(self, queries, spec: HybridSpec, metric: Metric,
                       ctx=None):
        return self._knn(queries, spec.k, metric, cut=spec.radius)

    def execute_range(self, queries, spec: RangeSpec, metric: Metric,
                      ctx=None):
        from ..planner import range_via_counted_topk

        res = range_via_counted_topk(
            self._pts_t, queries, spec, metric, backend=self.backend_name
        )
        self._queries_served += res.n_queries
        return res

    def stats(self) -> dict:
        s = super().stats()
        s["queries_served"] = self._queries_served
        return s
