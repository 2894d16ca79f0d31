"""Neighbor-search API of the port: build once, plan every query.

    from repro_torch.api import build_index, KnnSpec, RangeSpec, HybridSpec

    index = build_index(points, backend="trueknn")    # on the card
    res = index.query(batch, KnnSpec(k=8))            # KNNResult
    rng = index.query(batch, RangeSpec(radius=0.5))   # RangeResult (CSR)
    plan = index.prepare(KnnSpec(k=8)); plan(batch)   # plan once, run many

Same surface as ``repro.api`` for the ported backends (``brute``,
``fixed_radius``, ``trueknn``, ``distributed`` on a ``DeviceMesh``,
``sharded`` with ``placement="host"`` or ``"devices"``, and ``mutable``)
and every planner route (native hooks, ``knn_fallback``, ``knn_filter``,
``knn_sweep``, ``l2_view``, ``brute_metric``, ``all_pairs``, shard
pruning), plus the ``device`` build knob.  For mutation,
``backend="mutable"`` (or ``make_mutable(index)``, which adopts a built
index with no rebuild) composes an immutable base with brute delta
shards and tombstones — see ``repro_torch.api.mutable``.
``NeighborServer`` fronts resident indexes with a microbatching request
queue (``repro_torch.api.server``).
"""

from ..core.distributed import DeviceMesh
from ..core.result import KNNResult, RangeResult, RoundStats
from .metrics import (
    Metric,
    available_metrics,
    get_metric,
    normalize_rows,
    register_metric,
)
from .query import AllPairsSpec, HybridSpec, KnnSpec, QuerySpec, RangeSpec

from . import backends  # registers the built-in backends  # noqa: E402
from .index import NeighborIndex, build_index
from .mutable import CompactionPolicy, make_mutable, map_to_stable
from .plan import PlanContext, QueryPlan
from .registry import available_backends, get_backend, register_backend
from .server import (
    AdmissionError,
    NeighborServer,
    Ticket,
    dropped_counts,
    warm_default_radius,
)

__all__ = [
    "KNNResult",
    "RangeResult",
    "RoundStats",
    "DeviceMesh",
    "QuerySpec",
    "KnnSpec",
    "RangeSpec",
    "HybridSpec",
    "AllPairsSpec",
    "Metric",
    "register_metric",
    "get_metric",
    "available_metrics",
    "normalize_rows",
    "NeighborIndex",
    "build_index",
    "CompactionPolicy",
    "make_mutable",
    "map_to_stable",
    "QueryPlan",
    "PlanContext",
    "available_backends",
    "get_backend",
    "register_backend",
    "backends",
    "NeighborServer",
    "Ticket",
    "AdmissionError",
    "warm_default_radius",
    "dropped_counts",
]
