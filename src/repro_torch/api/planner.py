"""The query planner (port of ``repro.api.planner``), native routes only.

:func:`build_plan` resolves the metric, validates the spec and reifies the
route as a :class:`PlanNode` tree with no query data; :func:`run_plan`
executes it against a batch.  This slice of the port carries the native
route — each backend's own ``execute_*`` hook — and the shared helpers the
native paths use: ``empty_result``, ``apply_radius_cut``,
``resolve_self_queries``, ``range_from_counted_round`` (the grid
backends' native range) and ``range_via_counted_topk`` (the brute
backend's range on the ``pairwise_topk`` kernel's counter).

Every generic route of the reference (``knn_fallback``, ``knn_filter``,
``knn_sweep``, ``l2_view``, ``brute_metric``, ``all_pairs``) raises
``NotImplementedError`` naming the route when the plan is built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..core.grid import _next_pow2
from ..core.result import KNNResult, RangeResult
from .metrics import Metric, get_metric
from .query import AllPairsSpec, HybridSpec, KnnSpec, QuerySpec, RangeSpec

__all__ = [
    "PlanNode",
    "build_plan",
    "run_plan",
    "empty_result",
    "apply_radius_cut",
    "range_from_counted_round",
    "range_via_counted_topk",
    "resolve_self_queries",
]

_L2 = "l2"


def resolve_self_queries(index, queries):
    """A caller handing back the resident point array *itself* (by
    identity, never by value) means "the dataset queries itself": the
    canonical ``queries=None`` self path."""
    if queries is None:
        return None
    pts = getattr(index, "points", None)
    if pts is not None and queries is pts:
        return None
    return queries


def apply_radius_cut(dists, idxs, cut: float, sentinel: int):
    """The radius-cap post-filter: beyond-cut slots become inf/sentinel,
    ``found`` counts the survivors per row (inclusive ``<= cut``)."""
    dists = np.asarray(dists)
    idxs = np.asarray(idxs)
    within = dists <= cut
    found = within.sum(1).astype(np.int64)
    return (
        np.where(within, dists, np.inf).astype(np.float32),
        np.where(within, idxs, sentinel).astype(np.int32),
        found,
    )


# -- phase 1: plan construction ---------------------------------------------


@dataclasses.dataclass
class PlanNode:
    """One routing decision, reified (see ``repro.api.planner.PlanNode``).
    ``tag`` is the ``result.timings["plan"]`` string the route emits."""

    route: str
    backend: str
    spec: QuerySpec
    metric: str
    tag: str
    props: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def explain(self) -> dict:
        """Structured, JSON-serializable plan tree."""
        spec_d = {"kind": self.spec.kind}
        for f in dataclasses.fields(self.spec):
            v = getattr(self.spec, f.name)
            if v is not None:
                spec_d[f.name] = v
        out = {
            "route": self.route,
            "backend": self.backend,
            "spec": spec_d,
            "metric": self.metric,
            "tag": self.tag,
        }
        if self.props:
            out["props"] = dict(self.props)
        out["children"] = [c.explain() for c in self.children]
        return out


def _unported(route: str, index, spec, metric_name: str):
    return NotImplementedError(
        f"route {route!r} (backend {index.backend_name!r}, spec "
        f"{spec.kind!r}, metric {metric_name!r}) is not ported to "
        "repro_torch yet; only native routes are"
    )


def _has_native(index, kind: str) -> bool:
    """Structural capability check: does the backend override the hook?"""
    from .index import NeighborIndex

    base = getattr(NeighborIndex, f"execute_{kind}")
    return getattr(type(index), f"execute_{kind}", base) is not base


def _build_dispatch(index, spec, metric: Metric) -> PlanNode:
    """The native node, or the generic route the reference would take."""
    if isinstance(spec, KnnSpec):
        route = "native" if index.supports_knn_spec(spec) else "knn_fallback"
    elif isinstance(spec, RangeSpec):
        route = "native" if _has_native(index, "range") else "knn_sweep"
    elif isinstance(spec, HybridSpec):
        route = "native" if _has_native(index, "hybrid") else "knn_filter"
    else:
        raise TypeError(f"unknown QuerySpec kind: {type(spec).__name__}")
    if route != "native":
        raise _unported(route, index, spec, metric.name)
    tag, props, children = index.plan_details(spec, metric)
    return PlanNode("native", index.backend_name, spec, metric.name, tag,
                    props=props, children=children)


def build_plan(index, spec: QuerySpec, metric_name: str) -> PlanNode:
    """Construct the plan tree for (index, spec, metric) — no query data.
    Raises the reference's errors for invalid requests and
    ``NotImplementedError`` for routes this port does not carry yet."""
    metric = get_metric(metric_name)
    spec.validate()
    if isinstance(spec, AllPairsSpec):
        raise _unported("all_pairs", index, spec, metric.name)
    if metric.name in index.native_metrics:
        return _build_dispatch(index, spec, metric)
    if metric.has_l2_view and _L2 in index.native_metrics:
        raise _unported("l2_view", index, spec, metric.name)
    if metric.kernel_name is None:
        raise ValueError(
            f"metric {metric.name!r} has neither a fused engine form nor an "
            "L2 reduction; no backend can serve it"
        )
    if isinstance(spec, KnnSpec) and spec.stop_radius is not None:
        raise ValueError(
            f"stop_radius needs a radius-scheduled engine; backend "
            f"{index.backend_name!r} serves metric {metric.name!r} through "
            "the dense fallback — use HybridSpec for a radius cap"
        )
    raise _unported("brute_metric", index, spec, metric.name)


# -- phase 2: plan execution -------------------------------------------------


def run_plan(node: PlanNode, index, queries, ctx=None):
    """Execute a constructed plan tree (a native node: ``build_plan``
    makes no other yet) against a query batch."""
    hook = getattr(index, f"execute_{node.spec.kind}")
    return hook(queries, node.spec, get_metric(node.metric), ctx=ctx)


def _empty_range(q_total, spec, backend, metric_name, timings=None):
    return RangeResult(
        offsets=np.zeros((q_total + 1,), np.int64),
        idxs=np.empty((0,), np.int32),
        dists=np.empty((0,), np.float32),
        radius=spec.radius,
        backend=backend,
        metric=metric_name,
        truncated=(
            np.zeros((q_total,), bool) if spec.max_neighbors else None
        ),
        timings=timings or {},
    )


def empty_result(index, spec: QuerySpec, metric_name: str, *,
                 q_total: int = 0):
    """Well-formed *no-candidates* answer (``Q == 0`` batches, or queries
    against an empty index), tagged ``plan == "empty"``."""
    metric = get_metric(metric_name)
    q_total = int(q_total)
    timings = {"plan": "empty", "query_seconds": 0.0}
    if isinstance(spec, AllPairsSpec):
        spec = spec.lowered()
    if isinstance(spec, RangeSpec):
        return _empty_range(q_total, spec, index.backend_name, metric.name,
                            timings)
    sentinel = int(getattr(index, "sentinel", index.n_points))
    return KNNResult(
        dists=np.full((q_total, spec.k), np.inf, np.float32),
        idxs=np.full((q_total, spec.k), sentinel, np.int32),
        n_tests=0,
        backend=index.backend_name,
        metric=metric.name,
        found=np.zeros((q_total,), np.int64),
        timings=timings,
    )


# -- shared native-range helpers -------------------------------------------


def range_from_counted_round(
    round_fn: Callable,
    *,
    q_total: int,
    cap: int,
    spec: RangeSpec,
    backend: str,
    metric_name: str = _L2,
    timings_extra: Optional[dict] = None,
):
    """Range search through a *counted* round.

    ``round_fn(k) -> (dists (Q,k) metric-space ascending, idxs (Q,k),
    found (Q,) exact in-ball counts, n_tests)``.  Because ``found`` is the
    exact ball population, at most one re-run with ``k = found.max()``
    surfaces every neighbor.
    """
    t0 = time.perf_counter()
    maxn = spec.max_neighbors
    target = min(maxn, cap) if maxn else cap
    timings = dict(timings_extra or {})
    timings.setdefault("plan", "native")
    if q_total == 0 or cap == 0:
        timings["query_seconds"] = time.perf_counter() - t0
        return _empty_range(q_total, spec, backend, metric_name, timings)
    k0 = min(max((maxn + 1) if maxn else 32, 2), cap)
    d, ix, found, n_tests = round_fn(k0)
    found = np.asarray(found).astype(np.int64)
    total_tests = int(n_tests)
    kneed = int(min(found.max() if found.size else 0, target))
    rounds = 1
    if kneed > k0:
        d, ix, _, n_tests = round_fn(min(_next_pow2(kneed), cap))
        total_tests += int(n_tests)
        rounds += 1
    d = np.asarray(d)
    ix = np.asarray(ix)
    take = np.minimum(found, target)
    # row-major boolean masking keeps row order and nearest-first order
    keep = np.arange(d.shape[1])[None, :] < take[:, None]
    offsets = np.zeros((q_total + 1,), np.int64)
    np.cumsum(take, out=offsets[1:])
    truncated = (found > target) if maxn else None
    timings.update(count_rounds=rounds,
                   query_seconds=time.perf_counter() - t0)
    return RangeResult(
        offsets=offsets,
        idxs=ix[keep].astype(np.int32),
        dists=d[keep].astype(np.float32),
        radius=spec.radius,
        n_tests=int(total_tests),
        backend=backend,
        metric=metric_name,
        truncated=truncated,
        timings=timings,
    )


def range_via_counted_topk(points, queries, spec: RangeSpec, metric: Metric,
                           *, backend: str):
    """Native range plan on the ``pairwise_topk`` kernel: its in-radius
    counter returns exact ball populations, so the dense path needs at
    most two passes.  ``points`` is the resident cloud as a tensor (the
    kernel runs on its device); ``queries`` None is the self-query."""
    from ..kernels.ops import pairwise_topk, sqrt32

    n = points.shape[0]
    if queries is None:
        q = points
        qid = np.arange(n, dtype=np.int32)
        cap = n - 1
    else:
        q = np.asarray(queries, np.float32)
        qid = None
        cap = n

    def round_fn(k):
        d, ix, counts = pairwise_topk(
            q, points, int(k), radius=spec.radius, query_ids=qid,
            metric=metric.name,
        )
        if metric.name == _L2:
            d = sqrt32(d)  # the kernel returns squared distances for l2
        return d.cpu().numpy(), ix.cpu().numpy(), counts.cpu().numpy(), \
            q.shape[0] * n

    return range_from_counted_round(
        round_fn,
        q_total=q.shape[0],
        cap=cap,
        spec=spec,
        backend=backend,
        metric_name=metric.name,
        timings_extra={"plan": "counted_topk"},
    )
