"""QueryPlan — the prepare/execute query surface (port of
``repro.api.plan``).

    plan = index.prepare(KnnSpec(8))   # plan once
    res_a = plan(batch_a)              # execute many
    plan.explain()                     # inspect the route

Construction runs ``repro_torch.api.planner.build_plan`` with no query
data; ``explain()`` returns the structured route tree.  With
``canonical_shapes`` each call pads the query count up to a power of two
(padding rows are copies of row 0, sliced off before the caller sees the
answer) and counts shape buckets in ``cache_stats()``, as the reference
does, so the two packages report the same plan bookkeeping.  A plan
prepared at one index ``generation`` re-prepares when the index has
mutated since (the mutable composite), and counts it in
``invalidations``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.grid import _next_pow2
from ..core.result import slice_rows
from .metrics import get_metric
from .planner import build_plan, empty_result, resolve_self_queries, run_plan
from .query import QuerySpec

__all__ = ["QueryPlan", "PlanContext", "canonical_rows"]


def canonical_rows(m: int, floor: int = 1) -> int:
    """The canonical padded row count: the next power of two, floored at
    ``floor``."""
    return _next_pow2(max(int(m), int(floor)))


class PlanContext:
    """Execution context threaded through backend ``execute_*`` hooks.

    canonical_shapes: pad backend-internal batch subsets to canonical pow2
        shapes.
    warm_radius: shared warm-start radius seed in query-metric units.
    """

    __slots__ = ("plan", "canonical_shapes", "warm_radius")

    def __init__(self, plan: Optional["QueryPlan"] = None, *,
                 canonical_shapes: bool = False,
                 warm_radius: Optional[float] = None):
        self.plan = plan
        self.canonical_shapes = canonical_shapes
        self.warm_radius = warm_radius

    def record_bucket(self, key: tuple) -> bool:
        """Count one shape-bucket use; True on a hit.  No-op without a
        plan."""
        if self.plan is None:
            return False
        return self.plan._record_bucket(key)


class QueryPlan:
    """A prepared (spec, metric) search over one resident index.

    Build with ``index.prepare(spec, metric=...)``; run with
    ``plan(queries)`` (``queries=None``: the dataset queries itself).
    """

    def __init__(self, index, spec: QuerySpec, metric: str = "l2", *,
                 canonical_shapes: bool = True):
        if not isinstance(spec, QuerySpec):
            raise TypeError(
                f"spec must be a QuerySpec (KnnSpec / RangeSpec / "
                f"HybridSpec), got {type(spec).__name__}"
            )
        self.index = index
        self.spec = spec
        self.metric = get_metric(metric).name
        self.canonical_shapes = bool(canonical_shapes)
        self.root = build_plan(index, spec, self.metric)
        self.ctx = PlanContext(self, canonical_shapes=self.canonical_shapes)
        #: index generation this plan's route tree was built against
        self.generation = int(index.generation)
        #: times the route tree was rebuilt because the index mutated
        self.invalidations = 0
        self._buckets: dict = {}  # bucket key -> execution count
        self._hits = 0
        self._misses = 0
        self.executions = 0

    def _check_generation(self) -> None:
        """Staleness guard: once the index has mutated, rebuild the route
        tree (same spec and metric) and reset the shape buckets; the
        cumulative hit/miss counters are kept."""
        gen = int(self.index.generation)
        if gen != self.generation:
            self.root = build_plan(self.index, self.spec, self.metric)
            self.generation = gen
            self.invalidations += 1
            self._buckets.clear()

    def __call__(self, queries):
        """Execute the prepared plan; returns KNNResult or RangeResult."""
        self._check_generation()
        self.executions += 1
        queries = resolve_self_queries(self.index, queries)
        if self.index.n_points == 0:
            m = 0 if queries is None else np.asarray(queries).shape[0]
            return empty_result(
                self.index, self.spec, self.metric, q_total=m
            )
        if queries is None:
            self._record_bucket(("self", self.index.n_points))
            return run_plan(self.root, self.index, None, self.ctx)
        q = np.asarray(queries, np.float32)
        m = q.shape[0]
        if m == 0:
            return empty_result(self.index, self.spec, self.metric)
        if not self.canonical_shapes:
            self._record_bucket(("q", m))
            return run_plan(self.root, self.index, q, self.ctx)
        m_pad = canonical_rows(m)
        self._record_bucket(("q", m_pad))
        if m_pad > m:
            # duplicate row 0: rows are independent, answers unchanged
            q = np.concatenate([q, np.repeat(q[:1], m_pad - m, axis=0)])
        res = run_plan(self.root, self.index, q, self.ctx)
        if m_pad > m:
            res = slice_rows(res, m)
            res.timings["padded_rows"] = m_pad - m
        return res

    def explain(self) -> dict:
        """Structured plan tree; ``["tag"]`` renders the plan-tag string."""
        out = self.root.explain()
        out["canonical_shapes"] = self.canonical_shapes
        out["generation"] = self.generation
        return out

    def _record_bucket(self, key: tuple) -> bool:
        seen = key in self._buckets
        self._buckets[key] = self._buckets.get(key, 0) + 1
        if seen:
            self._hits += 1
        else:
            self._misses += 1
        return seen

    def cache_stats(self) -> dict:
        """Shape-bucket counters: a *bucket* is one query shape this plan
        has executed; a *hit* means that shape came again."""
        looked = self._hits + self._misses
        return {
            "executions": self.executions,
            "buckets": len(self._buckets),
            "hits": self._hits,
            "misses": self._misses,
            "hit_rate": round(self._hits / looked, 4) if looked else 0.0,
            "invalidations": self.invalidations,
        }

    def __repr__(self) -> str:
        return (
            f"QueryPlan({self.index.backend_name}, {self.spec}, "
            f"metric={self.metric!r}, route={self.root.route!r}, "
            f"executions={self.executions})"
        )
