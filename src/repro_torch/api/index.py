"""The ``NeighborIndex`` protocol and ``build_index`` entry point (port of
``repro.api.index``).

Build once, query many: a ``NeighborIndex`` holds the resident cloud —
a host copy for the numpy-side bookkeeping and a tensor on the index's
device for the kernels — and ``query`` is the hot-path call.  ``query``
takes a typed spec (``KnnSpec`` / ``RangeSpec`` / ``HybridSpec``) and a
metric name; the planner (``repro_torch.api.planner``) routes it to the
backend's native ``execute_*`` hook where the backend has one, and to the
reference's generic plans otherwise (knn-then-filter for hybrid, an
oversized-k sweep for range, a companion index over the transformed cloud
or the exact brute engine for metrics the backend lacks).

``device`` is a build knob of every backend: ``"cuda"`` (the default)
puts the index on the card and runs the CUDA kernels, ``"cpu"`` runs
their plain PyTorch versions.  Asking for ``cuda`` without a card raises.
"""

from __future__ import annotations

import abc
import inspect
from typing import Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..core.result import KNNResult, RangeResult
from ..core.spans import span
from .metrics import Metric
from .query import (
    HybridSpec,
    KnnSpec,
    QuerySpec,
    RangeSpec,
    warn_deprecated_once,
)
from .registry import get_backend

__all__ = ["NeighborIndex", "build_index"]


class NeighborIndex(abc.ABC):
    """A built search structure over a resident point cloud.

    Subclasses ingest ``points`` once in ``__init__`` (the *build*) and
    answer ``query`` repeatedly, carrying whatever state lets later batches
    go faster (cached grids, warm-start radii).  Backends implement
    ``execute_knn`` (mandatory) and may implement ``execute_range`` /
    ``execute_hybrid``; ``native_metrics`` names the metrics the backend's
    own engine handles.
    """

    backend_name: str = "?"
    #: metrics the backend's engine computes natively (planner contract)
    native_metrics: frozenset = frozenset({"l2"})
    #: cfg knobs that are radii in query-metric units; mapped through
    #: ``metric.radius_to_l2`` when a metric companion view is built
    radius_cfg_keys: tuple = ()
    #: what KnnSpec.start_radius means to this backend: a "seed" for the
    #: radius schedule or a hard "bound" on returned neighbors
    knn_start_radius_semantics: str = "seed"

    def __init__(self, points, device="cuda"):
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2:
            raise ValueError(f"points must be (N, d), got {pts.shape}")
        self._pts = pts
        self._device = resolve_device(device)
        #: the resident cloud on the index's device
        self._pts_t = torch.from_numpy(pts).to(self._device)
        self._metric_views: dict = {}  # metric name -> companion index
        self._generation = 0

    # -- introspection ----------------------------------------------------

    @property
    def points(self) -> np.ndarray:
        """The resident cloud (host copy, (N, d) float32)."""
        return self._pts

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_points(self) -> int:
        return self._pts.shape[0]

    @property
    def dim(self) -> int:
        return self._pts.shape[1]

    @property
    def generation(self) -> int:
        """Monotone mutation counter: 0 for the life of an immutable
        backend; the mutable composite bumps it on every insert / delete /
        compaction, and a ``QueryPlan`` prepared at another generation
        re-prepares (``repro_torch.api.plan``)."""
        return self._generation

    @property
    def sentinel(self) -> int:
        """The padding id in ``KNNResult.idxs`` (one past the largest
        valid dataset id)."""
        return self.n_points

    def __len__(self) -> int:
        return self.n_points

    def stats(self) -> dict:
        """Cumulative counters since build; backends extend this."""
        return {
            "backend": self.backend_name,
            "n_points": self.n_points,
            "dim": self.dim,
            "generation": self.generation,
            "metric_views": sorted(self._metric_views),
            "device": str(self._device),
        }

    # -- mutation (mutable composite only) --------------------------------

    def insert(self, points) -> np.ndarray:
        """Add points to the resident cloud.  Immutable backends raise;
        build with ``backend="mutable"`` (or wrap an existing index via
        ``repro_torch.api.mutable.make_mutable``) for streaming writes."""
        raise NotImplementedError(
            f"backend {self.backend_name!r} is immutable; build with "
            "backend='mutable' or wrap it: "
            "repro_torch.api.mutable.make_mutable(index)"
        )

    def delete(self, ids) -> int:
        """Remove points by dataset id.  Immutable backends raise; see
        :meth:`insert`."""
        raise NotImplementedError(
            f"backend {self.backend_name!r} is immutable; build with "
            "backend='mutable' or wrap it: "
            "repro_torch.api.mutable.make_mutable(index)"
        )

    # -- the hot path -----------------------------------------------------

    def query(
        self,
        queries,
        spec: Union[QuerySpec, int, None] = None,
        *,
        metric: str = "l2",
        k: Optional[int] = None,
        radius: Optional[float] = None,
        stop_radius: Optional[float] = None,
    ):
        """Answer ``spec`` over ``queries`` ((Q, d), or None to let the
        dataset query itself with self-exclusion).  Returns ``KNNResult``
        for knn/hybrid specs, ``RangeResult`` (ragged CSR) for range.

        Deprecated form: ``query(queries, k, radius=..., stop_radius=...)``
        (an int where the spec goes, or the ``k=`` keyword) adapts to
        ``KnnSpec(k, start_radius=radius, stop_radius=stop_radius)`` and
        warns once per process.
        """
        if isinstance(spec, (int, np.integer)):
            if k is not None:
                raise TypeError("query() got k twice (positional and keyword)")
            k, spec = int(spec), None
        if spec is None:
            if k is None:
                raise TypeError(
                    "query() needs a QuerySpec (e.g. KnnSpec(k=8)) — or the "
                    "deprecated k=... form"
                )
            warn_deprecated_once(
                "NeighborIndex.query:k",
                "NeighborIndex.query(queries, k, radius=..., stop_radius=...)"
                " is deprecated; pass a spec: query(queries, KnnSpec(k, "
                "start_radius=..., stop_radius=...))",
            )
            spec = KnnSpec(
                int(k), start_radius=radius, stop_radius=stop_radius
            )
        else:
            if not isinstance(spec, QuerySpec):
                raise TypeError(
                    f"spec must be a QuerySpec (KnnSpec / RangeSpec / "
                    f"HybridSpec), got {type(spec).__name__}"
                )
            if k is not None or radius is not None or stop_radius is not None:
                raise TypeError(
                    "pass either a QuerySpec or the legacy k/radius/"
                    "stop_radius keywords, not both"
                )
        from .plan import QueryPlan  # late import: plan imports index

        with span("repro_torch.query"):
            return QueryPlan(self, spec, metric,
                             canonical_shapes=False)(queries)

    def prepare(self, spec: QuerySpec, *, metric: str = "l2",
                canonical_shapes: bool = True):
        """Prepare a reusable :class:`repro_torch.api.plan.QueryPlan` for
        ``spec``/``metric``; ``plan(queries)`` per batch answers exactly
        what ``query`` does."""
        from .plan import QueryPlan

        return QueryPlan(self, spec, metric, canonical_shapes=canonical_shapes)

    # -- backend capability hooks (planner contract) ----------------------

    def supports_knn_spec(self, spec: KnnSpec) -> bool:
        """Whether ``execute_knn`` serves this spec variant natively."""
        return True

    def plan_details(self, spec: QuerySpec, metric: Metric) -> tuple:
        """(tag, props, children) of this backend's native plan node."""
        return "native", {}, []

    @abc.abstractmethod
    def execute_knn(
        self, queries, spec: KnnSpec, metric: Metric, ctx=None
    ) -> KNNResult:
        """Native kNN path; ``metric`` is guaranteed ∈ ``native_metrics``."""

    def execute_range(
        self, queries, spec: RangeSpec, metric: Metric, ctx=None
    ) -> RangeResult:
        """Native range path (absent: the planner needs a generic route)."""
        raise NotImplementedError

    def execute_hybrid(
        self, queries, spec: HybridSpec, metric: Metric, ctx=None
    ) -> KNNResult:
        """Native radius-capped kNN (absent: generic route)."""
        raise NotImplementedError

    def knn_spec_radius_cut(self, spec: KnnSpec):
        """The radius bound this backend applies to a ``KnnSpec`` answer
        (None = unbounded).  Generic plans honor it, so a spec keeps one
        meaning on a backend whatever metric route answers it: "bound"
        backends cap at ``start_radius``, "seed" backends treat it as a
        scheduling hint with no effect on the answer set."""
        if self.knn_start_radius_semantics == "bound":
            return spec.start_radius
        return None

    # -- metric companion views -------------------------------------------

    def metric_view(self, metric: Metric) -> "NeighborIndex":
        """Companion index of the same backend over the metric's transformed
        cloud (built lazily, cached for the life of this index), on this
        index's device.  Grids, round schedules and warm-start state all
        operate in transformed space; only distances and radii are mapped
        at the planner boundary."""
        if not metric.has_l2_view:
            raise ValueError(f"metric {metric.name!r} has no L2 view")
        view = self._metric_views.get(metric.name)
        if view is None:
            cfg = dict(getattr(self, "_build_cfg", None) or {})
            # radius-valued knobs were given in query-metric units; the
            # companion searches transformed (L2) space, so map them
            for key in self.radius_cfg_keys:
                if cfg.get(key) is not None:
                    cfg[key] = metric.radius_to_l2(float(cfg[key]))
            # the device is this index's own, whatever the stashed cfg says
            # (an index built by its constructor has none)
            cfg["device"] = self._device
            view = type(self)(metric.transform_points(self._pts), **cfg)
            view._build_cfg = cfg
            self._metric_views[metric.name] = view
        return view


def _valid_cfg_keys(cls) -> Optional[set]:
    """Keyword knobs of ``cls.__init__`` past (self, points); None means
    "accepts anything" (a **cfg backend validates its own)."""
    params = list(inspect.signature(cls.__init__).parameters.values())[2:]
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return None
    return {
        p.name
        for p in params
        if p.kind
        in (
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
            inspect.Parameter.KEYWORD_ONLY,
        )
    }


def build_index(points, *, backend: str = "trueknn", **cfg) -> NeighborIndex:
    """Build a resident neighbor-search index.

    Usage::

        from repro_torch import KnnSpec, RangeSpec, build_index
        index = build_index(pts, backend="trueknn")   # on the card
        res = index.query(batch, KnnSpec(k=8))        # KNNResult
        rng = index.query(batch, RangeSpec(radius=r)) # RangeResult (CSR)

    ``cfg`` is passed to the backend constructor; every backend takes
    ``device`` ("cuda" by default, "cpu" for the plain versions).  Unknown
    keys are rejected up front with the backend's valid knob list.
    """
    cls = get_backend(backend)
    valid = _valid_cfg_keys(cls)
    if valid is not None:
        unknown = sorted(set(cfg) - valid)
        if unknown:
            raise ValueError(
                f"unknown config key(s) {unknown} for backend {backend!r}; "
                f"valid knobs: {sorted(valid)}"
            )
    index = cls(points, **cfg)
    if not isinstance(index, NeighborIndex):
        raise TypeError(
            f"backend {backend!r} ({cls.__name__}) must subclass NeighborIndex"
        )
    # remembered so metric companion views rebuild with the same knobs
    index._build_cfg = dict(cfg)
    return index
