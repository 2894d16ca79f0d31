"""The query planner (port of ``repro.api.planner``): one routing layer
between specs and backend engines.

* **Plan construction** — :func:`build_plan` resolves the metric, validates
  the spec and reifies the chosen route as a structured, inspectable
  :class:`PlanNode` tree (route, metric view, fallbacks) with no query
  data; it is what ``index.prepare(spec, metric=...)`` does once.
* **Plan execution** — :func:`run_plan` walks a constructed tree against a
  concrete query batch, threading a ``PlanContext``
  (``repro_torch.api.plan``) into every backend ``execute_*`` hook.

:func:`execute` is construct-then-run in one step.

Routing rules:

1. native work goes to the backend's ``execute_*`` hook
   (``execute_knn`` always exists; ``execute_range`` / ``execute_hybrid``
   and spec variants may be unsupported),
2. every gap is covered by a *generic plan*:

   * knn variant the backend's engine rejects -> a cached companion
     trueknn index over the same cloud, on the same device,
   * hybrid without a native path      -> knn-then-filter,
   * range without a native path       -> oversized-k hybrid sweep (double
     k until each query's ball is provably exhausted),
   * metric with an exact monotone L2 reduction (cosine) on an L2-only
     backend -> search a companion index over the transformed cloud and
     map distances back at the boundary (the Arkade trick),
   * metric with neither (L1 / L∞ on grid engines) -> the exact
     metric-aware brute engine (the ``pairwise_topk`` kernel on the card).

Generic plans tag ``result.timings["plan"]``; the same strings are the
``tag`` of each ``PlanNode`` (``plan.explain()``).

The planner also owns the *shard-pruning* vocabulary of the composite
``sharded`` backend: :func:`shard_visit_mask` is the radius-aware pruning
decision (a shard whose AABB lower bound exceeds the query's current
radius cut cannot hold an answer, so it is skipped without a distance
test — RTNN's search-space restriction), and :func:`shard_plan_tag`
renders the ``sharded/pruned=<m-of-n>`` plan tag every pruned plan
carries.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import time
from typing import Callable, Optional

import numpy as np

from ..core.grid import _next_pow2
from ..core.result import (
    KNNResult,
    RangeResult,
    slice_rows,
    strip_self_csr,
    strip_self_knn,
)

from .metrics import Metric, get_metric
from .query import AllPairsSpec, HybridSpec, KnnSpec, QuerySpec, RangeSpec

__all__ = [
    "PlanNode",
    "build_plan",
    "run_plan",
    "execute",
    "empty_result",
    "apply_radius_cut",
    "range_from_counted_round",
    "range_via_counted_topk",
    "resolve_self_queries",
    "shard_visit_mask",
    "shard_plan_tag",
    "placed_plan_tag",
]

_L2 = "l2"


def shard_visit_mask(bounds, cut) -> np.ndarray:
    """Radius-aware shard pruning: which (query, shard) pairs can possibly
    hold an answer within ``cut``.

    ``bounds`` is (Q, S) lower bounds on the distance from each query to
    anything inside each shard (AABB excess bounds, deflated for float32
    engine rounding — see ``repro_torch.core.partition``); ``cut`` is the
    query's current radius — a scalar, or (Q,) per-query cuts (TrueKNN
    rounds grow it, range/hybrid specs fix it up front).  Inclusive at the
    boundary, matching every engine's ``<= r`` in-radius test, so pruning
    never changes an answer — only the work done to produce it.
    """
    bounds = np.asarray(bounds)
    cut = np.asarray(cut, np.float64)
    if cut.ndim == 1:
        cut = cut[:, None]
    return bounds <= cut


def shard_plan_tag(visited: int, potential: int) -> str:
    """``sharded/pruned=<m-of-n>``: m of the n potential (query, shard)
    visits were pruned away this call."""
    return f"sharded/pruned={int(potential) - int(visited)}-of-{int(potential)}"


def placed_plan_tag(visited: int, potential: int, dispatches: int) -> str:
    """The device-placed flavor of :func:`shard_plan_tag`: same pruning
    count (the placed path prunes identically — masks are data), plus how
    many fused dispatches answered the whole call.  Keeps the
    ``sharded/pruned=`` prefix so every existing tag consumer still
    parses it."""
    return shard_plan_tag(visited, potential) + f"/placed={int(dispatches)}"


def resolve_self_queries(index, queries):
    """THE "queries is the index's own cloud" detection, centralized.

    Every backend spells self-queries as ``queries=None`` (qid-based
    self-exclusion in the engines, ``strip_self_*`` in the composites).
    Callers that pass the resident point array *itself* mean the same
    search; canonicalizing here — by object identity, never by value
    (an equal copy is a foreign batch whose rows may legitimately match
    themselves) — guarantees every backend applies identical
    self-exclusion semantics instead of each call site re-deciding.
    """
    if queries is None:
        return None
    pts = getattr(index, "points", None)
    if pts is not None and queries is pts:
        return None
    return queries


def apply_radius_cut(dists, idxs, cut: float, sentinel: int):
    """THE radius-cap post-filter (hybrid plans, brute ``start_radius``
    bounds, the trueknn hybrid brute tail all share it): beyond-cut slots
    become inf/sentinel, ``found`` counts the survivors per row.  Boundary
    is inclusive (``<= cut``), matching every engine's in-radius test."""
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
    """One routing decision, reified.

    A constructed plan is a tree of these: the root is the route chosen
    for (backend, spec, metric); ``children`` are the routes it delegates
    to (the companion search under an ``l2_view`` or ``knn_fallback``
    node, the inner dispatch of a generic sweep/filter, the two children
    of an ``all_pairs`` node).  ``tag`` is the ``result.timings["plan"]``
    string the route emits at execution time, so ``explain()`` renders
    what the tag reports, plus the structure it flattens away.
    """

    route: str
    backend: str
    spec: QuerySpec
    metric: str
    tag: str
    props: dict = dataclasses.field(default_factory=dict)
    #: child PlanNodes, or a zero-arg thunk building them on first
    #: explain() (a backend may defer children nobody reads)
    children: object = dataclasses.field(default_factory=list)

    def resolved_children(self) -> list:
        if callable(self.children):
            self.children = self.children()
        return self.children

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
        out["children"] = [c.explain() for c in self.resolved_children()]
        return out


@functools.lru_cache(maxsize=None)
def _hook_accepts_ctx(cls: type, kind: str) -> bool:
    """Whether ``cls.execute_<kind>`` takes the plan-context argument
    (third-party backends written against the pre-QueryPlan hook signature
    keep working — they just don't see the context)."""
    fn = getattr(cls, f"execute_{kind}", None)
    if fn is None:
        return False
    try:
        return "ctx" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        return False


def _has_native(index, kind: str) -> bool:
    """Structural capability check: does the backend override the hook?"""
    from .index import NeighborIndex

    base = getattr(NeighborIndex, f"execute_{kind}")
    return getattr(type(index), f"execute_{kind}", base) is not base


def _native_node(index, spec, metric: Metric) -> PlanNode:
    tag, props, children = index.plan_details(spec, metric)
    return PlanNode(
        route="native",
        backend=index.backend_name,
        spec=spec,
        metric=metric.name,
        tag=tag,
        props=props,
        children=children,
    )


def _build_dispatch(index, spec, metric: Metric) -> PlanNode:
    """Route a native-metric spec: backend hook, or a generic plan."""
    name = index.backend_name
    if isinstance(spec, KnnSpec):
        if index.supports_knn_spec(spec):
            return _native_node(index, spec, metric)
        view = getattr(index, "_knn_fallback_view", None)
        child = (
            build_plan(view, spec, metric.name)
            if view is not None
            else PlanNode("native", "trueknn", spec, metric.name, "native",
                          props={"companion": "built lazily on first run"})
        )
        return PlanNode(
            "knn_fallback", name, spec, metric.name, "knn_fallback",
            props={"companion_backend": "trueknn"}, children=[child],
        )
    if isinstance(spec, RangeSpec):
        if _has_native(index, "range"):
            return _native_node(index, spec, metric)
        maxn = spec.max_neighbors
        cap = max(1, index.n_points)
        k0 = min(max((maxn + 1) if maxn else 32, 2), cap)
        return PlanNode(
            "knn_sweep", name, spec, metric.name, "knn_sweep",
            props={"initial_k": k0, "strategy": "double k until got < k"},
            children=[_build_dispatch(index, HybridSpec(k0, spec.radius),
                                      metric)],
        )
    if isinstance(spec, HybridSpec):
        if _has_native(index, "hybrid"):
            return _native_node(index, spec, metric)
        return PlanNode(
            "knn_filter", name, spec, metric.name, "knn_filter",
            props={"cut": spec.radius},
            children=[_build_dispatch(index, KnnSpec(spec.k), metric)],
        )
    raise TypeError(f"unknown QuerySpec kind: {type(spec).__name__}")


def build_plan(index, spec: QuerySpec, metric_name: str) -> PlanNode:
    """Construct the plan tree for (index, spec, metric) — no query data.

    Raises the same errors the old per-call surface raised (unknown
    metric, spec variants a route cannot serve), so ``prepare`` fails as
    fast as ``query`` did.
    """
    metric = get_metric(metric_name)
    spec.validate()
    if isinstance(spec, AllPairsSpec):
        return _build_all_pairs(index, spec, metric)
    if metric.name in index.native_metrics:
        return _build_dispatch(index, spec, metric)
    if metric.has_l2_view and _L2 in index.native_metrics:
        child = _build_dispatch(
            index, _transform_spec(spec, metric), get_metric(_L2)
        )
        return PlanNode(
            "l2_view", index.backend_name, spec, metric.name, "l2_view",
            props={"transform": f"{metric.name} -> l2 (monotone)"},
            children=[child],
        )
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
    return PlanNode(
        "brute_metric", index.backend_name, spec, metric.name, "brute_metric",
        props={"engine": "exact metric-aware dense"},
    )


def _build_all_pairs(index, spec: AllPairsSpec, metric: Metric) -> PlanNode:
    """Route the self-query workload spec.  Metric dispatch happens in the
    *children* (the lowered ordinary specs), so cosine all-pairs rides the
    l2_view companion exactly like a cosine KnnSpec would.

    Two children: the whole-batch plan (``queries=None`` — the backend's
    own self path) and the chunk plan
    (explicit row blocks over-fetched by the self slot, stripped with
    ``strip_self_knn``/``strip_self_csr`` after each block).
    """
    n = index.n_points
    if spec.mode == "knn" and n > 0 and spec.k > n - 1:
        raise ValueError(
            f"AllPairsSpec(k={spec.k}) asks for k self-excluded neighbors "
            f"but the index holds only {n} points (k must be <= n-1)"
        )
    chunk_spec = (
        KnnSpec(spec.k + 1)
        if spec.mode == "knn"
        else RangeSpec(spec.radius)
    )
    tag = (
        "all_pairs"
        if spec.chunk_rows is None
        else f"all_pairs/chunked={spec.chunk_rows}"
    )
    return PlanNode(
        "all_pairs", index.backend_name, spec, metric.name, tag,
        props={
            "mode": spec.mode,
            "self_excluded": True,
            "chunk_rows": spec.chunk_rows,
        },
        children=[
            build_plan(index, spec.lowered(), metric.name),
            build_plan(index, chunk_spec, metric.name),
        ],
    )


# -- phase 2: plan execution -------------------------------------------------


def _call_hook(index, kind: str, queries, spec, metric: Metric, ctx):
    fn = getattr(index, f"execute_{kind}")
    if _hook_accepts_ctx(type(index), kind):
        return fn(queries, spec, metric, ctx=ctx)
    return fn(queries, spec, metric)


def run_plan(node: PlanNode, index, queries, ctx=None):
    """Execute a constructed plan tree against a query batch."""
    metric = get_metric(node.metric)
    spec = node.spec
    if node.route == "native":
        try:
            return _call_hook(index, spec.kind, queries, spec, metric, ctx)
        except NotImplementedError:
            # a backend declared structural support it cannot honor at run
            # time (third-party hooks predating supports_knn_spec): cover
            # with the matching generic plan, exactly as the old dispatcher
            if isinstance(spec, KnnSpec):
                return _knn_via_fallback(index, queries, spec, metric, ctx)
            if isinstance(spec, RangeSpec):
                return _range_via_knn(index, queries, spec, metric, ctx)
            return _hybrid_via_knn(index, queries, spec, metric, ctx)
    if node.route == "knn_fallback":
        return _knn_via_fallback(index, queries, spec, metric, ctx)
    if node.route == "knn_sweep":
        return _range_via_knn(index, queries, spec, metric, ctx)
    if node.route == "knn_filter":
        return _hybrid_via_knn(index, queries, spec, metric, ctx)
    if node.route == "l2_view":
        return _via_l2_view(index, queries, spec, metric, ctx)
    if node.route == "brute_metric":
        return _brute_plan(index, queries, spec, metric, ctx)
    if node.route == "all_pairs":
        return _run_all_pairs(index, queries, spec, node, metric, ctx)
    raise ValueError(f"unknown plan route {node.route!r}")


def execute(index, queries, spec: QuerySpec, metric_name: str, ctx=None):
    """Plan and run ``spec`` on ``index``; returns KNNResult or RangeResult.

    The legacy one-shot entry: construct-then-run.  ``index.query`` goes
    through a throwaway ``QueryPlan`` that lands here; prepared plans call
    :func:`run_plan` on their cached tree instead.
    """
    queries = resolve_self_queries(index, queries)
    return run_plan(build_plan(index, spec, metric_name), index, queries, ctx)


def empty_result(index, spec: QuerySpec, metric_name: str, *,
                 q_total: int = 0):
    """Well-formed *no-candidates* answer for any (spec, metric, backend).

    Two cases share this shape, and neither may touch an engine (the
    kernels' chunk math assumes at least one row on both sides):

    * ``Q == 0`` batches (``q_total=0``, the default) — nothing to search;
    * queries against an *empty index* (``index.n_points == 0`` — a
      mutable index before its first insert, or drained by deletes) —
      ``q_total`` rows of inf-dists/sentinel-idxs with ``found == 0``
      (knn/hybrid), or ``q_total`` empty CSR rows (range).

    Tagged ``plan == "empty"``.  The idx fill value is the index's
    ``sentinel`` (== ``n_points`` everywhere but the mutable composite,
    whose stable-id space outlives deletion).
    """
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


def _dispatch(index, queries, spec, metric: Metric, ctx=None):
    """Native hook, or generic plan where the hook is missing (inner
    dispatch used by generic plans whose sub-spec is shaped at run time —
    the sweep's growing k, the view's transformed spec)."""
    return run_plan(_build_dispatch(index, spec, metric), index, queries, ctx)


# -- the all-pairs (self-query workload) route ------------------------------


def _run_all_pairs(index, queries, spec: AllPairsSpec, node: PlanNode,
                   metric: Metric, ctx=None):
    """Execute the self-query workload: the dataset against itself.

    Unchunked, this is the backend's own ``queries=None`` self path (the
    exact self-excluded answer).  With ``chunk_rows`` set, row blocks
    stream through the chunk child — over-fetched by one slot for the
    self entry, stripped per block — so a million-row cloud runs at one
    block shape and bounded output memory.  Both paths give the same
    answer: the engines are exact, and each orders neighbors at equal
    distance the same way whatever the batching.
    """
    if queries is not None:
        raise ValueError(
            "AllPairsSpec queries the index's own points: pass queries=None "
            "(or the resident index.points array itself)"
        )
    t0 = time.perf_counter()
    whole_node, chunk_node = node.resolved_children()
    n = index.n_points
    c = spec.chunk_rows
    if c is None or c >= n:
        res = run_plan(whole_node, index, None, ctx)
        inner = res.timings.get("plan")
        if inner and inner != "native":
            res.timings["plan_inner"] = inner
        res.timings["plan"] = "all_pairs"
        res.timings["query_seconds"] = time.perf_counter() - t0
        return res

    pts = np.asarray(index.points)
    sentinel = int(getattr(index, "sentinel", n))
    knn_d, knn_i, csr_parts = [], [], []
    total_tests = 0
    n_chunks = 0
    for i0 in range(0, n, c):
        i1 = min(i0 + c, n)
        m = i1 - i0
        q = pts[i0:i1]
        if m < c:
            # pad the tail block by repeating row 0: every block runs at
            # one shape; pad rows are sliced away before stripping
            q = np.concatenate([q, np.repeat(pts[:1], c - m, axis=0)])
        part = run_plan(chunk_node, index, q, ctx)
        total_tests += int(part.n_tests)
        n_chunks += 1
        part = slice_rows(part, m)
        ids = np.arange(i0, i1)
        if spec.mode == "knn":
            d, ix = strip_self_knn(
                np.asarray(part.dists), np.asarray(part.idxs), ids,
                spec.k, sentinel,
            )
            knn_d.append(d)
            knn_i.append(ix)
        else:
            csr_parts.append(strip_self_csr(part, ids))
    timings = {
        "plan": f"all_pairs/chunked={c}",
        "chunks": n_chunks,
        "query_seconds": time.perf_counter() - t0,
    }
    if spec.mode == "knn":
        return KNNResult(
            dists=np.concatenate(knn_d).astype(np.float32),
            idxs=np.concatenate(knn_i).astype(np.int32),
            n_tests=total_tests,
            backend=index.backend_name,
            metric=metric.name,
            timings=timings,
        )
    counts = np.concatenate([p.counts for p in csr_parts])
    offsets = np.zeros((n + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    return RangeResult(
        offsets=offsets,
        idxs=np.concatenate([p.idxs for p in csr_parts]).astype(np.int32),
        dists=np.concatenate([p.dists for p in csr_parts]).astype(np.float32),
        radius=spec.radius,
        n_tests=total_tests,
        backend=index.backend_name,
        metric=metric.name,
        timings=timings,
    )


# -- generic plan: knn via a companion engine -------------------------------


def _knn_via_fallback(index, queries, spec: KnnSpec, metric: Metric,
                      ctx=None):
    """Serve a ``KnnSpec`` variant the backend's own engine rejects
    (``supports_knn_spec`` said no — e.g. ``stop_radius`` on a backend
    with no radius schedule to stop).

    A cached companion ``trueknn`` index over the same resident cloud, on
    the index's device, answers instead: it implements the full KnnSpec
    surface (radius schedule, stop_radius tails) exactly, so the spec
    keeps one meaning everywhere — the answer is merely "not yet fast" on
    this backend.
    The plan is tagged ``knn_fallback`` with the original backend name
    kept on the result.
    """
    t0 = time.perf_counter()
    view = getattr(index, "_knn_fallback_view", None)
    if view is None:
        from .backends.trueknn import TrueKNNIndex

        view = TrueKNNIndex(index.points, device=index.device)
        index._knn_fallback_view = view
    res = execute(view, queries, spec, metric.name, ctx)
    res.backend = index.backend_name
    res.timings["plan"] = "knn_fallback"
    res.timings["query_seconds"] = time.perf_counter() - t0
    return res


# -- generic plan: hybrid = knn then filter ---------------------------------


def _hybrid_via_knn(index, queries, spec: HybridSpec, metric: Metric,
                    ctx=None):
    res = _call_hook(index, "knn", queries, KnnSpec(spec.k), metric, ctx)
    res.dists, res.idxs, res.found = apply_radius_cut(
        res.dists, res.idxs, spec.radius, index.n_points
    )
    res.timings["plan"] = "knn_filter"
    return res


# -- generic plan: range = oversized-k hybrid sweep -------------------------


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


def _csr_from_rows(rows_i, rows_d, spec, *, n_tests, backend, metric_name,
                   truncated, timings):
    offsets = np.zeros((len(rows_i) + 1,), np.int64)
    for i, r in enumerate(rows_i):
        offsets[i + 1] = offsets[i] + (0 if r is None else len(r))
    idxs = (
        np.concatenate([r for r in rows_i if r is not None and len(r)])
        if offsets[-1]
        else np.empty((0,), np.int32)
    ).astype(np.int32)
    dists = (
        np.concatenate([r for r in rows_d if r is not None and len(r)])
        if offsets[-1]
        else np.empty((0,), np.float32)
    ).astype(np.float32)
    return RangeResult(
        offsets=offsets,
        idxs=idxs,
        dists=dists,
        radius=spec.radius,
        n_tests=int(n_tests),
        backend=backend,
        metric=metric_name,
        truncated=truncated,
        timings=timings,
    )


def _range_via_knn(index, queries, spec: RangeSpec, metric: Metric,
                   ctx=None):
    """Oversized-k sweep: run radius-capped kNN with growing k until every
    query's ball is provably exhausted (``got < k``) or its row cap is
    met.  Works on any backend that answers kNN — the completeness test
    needs only the returned distances, never backend-specific counters."""
    t0 = time.perf_counter()
    n = index.n_points
    self_query = queries is None
    q_all = None if self_query else np.asarray(queries, np.float32)
    q_total = n if self_query else q_all.shape[0]
    cap = (n - 1) if self_query else n
    maxn = spec.max_neighbors
    target = min(maxn, cap) if maxn else cap
    timings = {"plan": "knn_sweep"}
    if q_total == 0 or cap == 0:
        timings["query_seconds"] = time.perf_counter() - t0
        return _empty_range(q_total, spec, index.backend_name, metric.name,
                            timings)

    rows_i = [None] * q_total
    rows_d = [None] * q_total
    truncated = np.zeros((q_total,), bool) if maxn else None
    pending = np.arange(q_total)
    # k > target wherever possible, so "got < k" proves the ball exhausted
    # and row truncation is decided exactly, not guessed.
    k = min(max((maxn + 1) if maxn else 32, 2), cap)
    total_tests = 0
    sweeps = 0
    while pending.size:
        sweeps += 1
        sub = None if self_query else q_all[pending]
        res = _dispatch(index, sub, HybridSpec(k, spec.radius), metric, ctx)
        total_tests += int(res.n_tests)
        d = np.asarray(res.dists)
        ix = np.asarray(res.idxs)
        got = np.isfinite(d).sum(1).astype(np.int64)
        complete = (got < k) | (k >= cap)
        glob = np.arange(q_total) if self_query else pending
        for li in np.flatnonzero(complete):
            gi = int(glob[li])
            m = int(min(got[li], target))
            rows_d[gi] = d[li, :m]
            rows_i[gi] = ix[li, :m]
            if truncated is not None:
                truncated[gi] = got[li] > target
        incomplete = ~complete
        pending = (
            np.flatnonzero(incomplete) if self_query else pending[incomplete]
        )
        if pending.size:
            hint = None
            if res.found is not None:
                fmax = int(np.asarray(res.found)[incomplete].max())
                hint = fmax + 1  # need k strictly above the count for proof
            k = min(_next_pow2(max(hint or 0, k * 2)), cap)
    timings.update(sweeps=sweeps, final_k=k,
                   query_seconds=time.perf_counter() - t0)
    return _csr_from_rows(
        rows_i, rows_d, spec, n_tests=total_tests,
        backend=index.backend_name, metric_name=metric.name,
        truncated=truncated, timings=timings,
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
    """Range search through a *counted* fixed-radius round.

    ``round_fn(k) -> (dists (Q,k) metric-space ascending, idxs (Q,k),
    found (Q,) exact in-ball counts, n_tests)``.  Because ``found`` is the
    exact ball population (the kernels' in-radius counter), at most one
    re-run with ``k = found.max()`` surfaces every neighbor — this is the
    native ``RangeSpec`` engine for the grid backends and the dense
    ``pairwise_topk`` path.
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
    # vectorized CSR: row-major boolean masking preserves row order and the
    # engines' nearest-first order within each row (no Python per-row loop
    # on this hot path)
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


# -- generic plan: exact monotone L2 reduction (companion view) -------------


def _transform_spec(spec, metric: Metric):
    r2l = metric.radius_to_l2
    if isinstance(spec, KnnSpec):
        return KnnSpec(
            spec.k,
            start_radius=(
                r2l(spec.start_radius) if spec.start_radius is not None else None
            ),
            stop_radius=(
                r2l(spec.stop_radius) if spec.stop_radius is not None else None
            ),
        )
    if isinstance(spec, RangeSpec):
        return RangeSpec(r2l(spec.radius), max_neighbors=spec.max_neighbors)
    if isinstance(spec, HybridSpec):
        return HybridSpec(spec.k, r2l(spec.radius))
    raise TypeError(type(spec).__name__)


def _via_l2_view(index, queries, spec, metric: Metric, ctx=None):
    """Serve a reducible metric through an L2 backend: search the companion
    index over the transformed cloud, map distances/radii back at the
    boundary.  Per-round telemetry (``rounds``) stays in engine (L2)
    units."""
    view = index.metric_view(metric)
    tq = (
        None
        if queries is None
        else metric.transform_points(np.asarray(queries, np.float32))
    )
    res = _dispatch(
        view, tq, _transform_spec(spec, metric), get_metric(_L2), ctx
    )
    back = metric.dist_from_l2
    res.metric = metric.name
    res.backend = index.backend_name
    res.timings["plan"] = "l2_view"
    if isinstance(res, RangeResult):
        res.dists = np.asarray(back(np.asarray(res.dists)), np.float32)
        res.radius = spec.radius
        return res
    res.dists = np.asarray(back(np.asarray(res.dists)), np.float32)
    if res.start_radius is not None:
        res.start_radius = float(back(np.float64(res.start_radius)))
    if res.final_radius is not None:
        res.final_radius = float(back(np.float64(res.final_radius)))
    return res


# -- generic plan: exact metric-aware brute engine --------------------------


def _brute_plan(index, queries, spec, metric: Metric, ctx=None):
    """Last-resort exact plan for metrics the backend can neither compute
    natively nor reach through an L2 reduction (L1/L∞ on grid engines):
    the structure is bypassed, the metric-aware dense engines answer.
    (``build_plan`` already rejected metrics with no engine form and
    ``stop_radius`` specs, which this route cannot serve.)"""
    from ..core.brute import brute_knn_engine

    if isinstance(spec, RangeSpec):
        res = range_via_counted_topk(
            index._pts_t, queries, spec, metric, backend=index.backend_name
        )
        res.timings["plan"] = "brute_metric"
        return res

    t0 = time.perf_counter()
    k = spec.k
    d, i, n_tests = brute_knn_engine(
        index._pts_t, k, queries=queries, metric=metric.kernel_name
    )
    dists = d.cpu().numpy()
    idxs = i.cpu().numpy()
    found = None
    if isinstance(spec, HybridSpec):
        cut = spec.radius
    else:
        # a KnnSpec keeps the backend's OWN radius semantics whatever
        # metric route answers it: "bound" backends (brute, fixed_radius —
        # including fixed_radius's cfg default radius) cap the answer,
        # "seed" backends return it unbounded
        cut = index.knn_spec_radius_cut(spec)
    if cut is not None:
        dists, idxs, found = apply_radius_cut(
            dists, idxs, cut, index.n_points
        )
    return KNNResult(
        dists=dists,
        idxs=idxs,
        n_tests=int(n_tests),
        backend=index.backend_name,
        metric=metric.name,
        found=found,
        timings={
            "plan": "brute_metric",
            "query_seconds": time.perf_counter() - t0,
        },
    )
