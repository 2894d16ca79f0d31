"""TrueKNN — unbounded multi-round kNN (paper Algorithm 3), the deprecated
free function (port of ``repro.core.trueknn``).

The engine lives behind the build-once/query-many API as the
``"trueknn"`` backend (``repro_torch.api.backends.trueknn``), where built
grids cache across query batches and start radii warm-start from the
previous batches' resolved-radius distribution.  This module keeps the
historical free function as a thin deprecated shim over the registry — it
builds a fresh index per call, so it pays structure construction every
time.  Serving loops should hold a ``NeighborIndex`` instead::

    from repro_torch.api import KnnSpec, build_index
    index = build_index(points, backend="trueknn")
    res = index.query(queries, KnnSpec(k))    # KNNResult; repeat cheaply

``TrueKNNResult`` is an alias of the unified ``KNNResult`` (the old field
names survive as properties), and ``RoundStats`` lives in
``repro_torch.core.result``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .result import KNNResult, RoundStats

__all__ = ["trueknn", "TrueKNNResult", "RoundStats"]

# legacy name: pre-API code annotated results as TrueKNNResult
TrueKNNResult = KNNResult


def trueknn(
    points,
    k: int,
    *,
    queries: Optional[np.ndarray] = None,
    start_radius: Optional[float] = None,
    growth: float = 2.0,
    max_rounds: int = 64,
    stop_radius: Optional[float] = None,
    chunk: int = 2048,
    seed: int = 0,
    device="cuda",
) -> KNNResult:
    """Deprecated shim: unbounded kNN via the registry's "trueknn" backend.

    Builds a throwaway index per call; prefer ``build_index`` + repeated
    ``query`` wherever the point cloud is resident.  ``stop_radius``
    implements the paper's 99th-percentile thought experiment (Sec. 5.5.1):
    terminate once the radius exceeds it, leaving tail queries with however
    many neighbors they found (``result.found`` counts them).  ``device``
    is the index's: ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``.
    """
    from ..api import KnnSpec, build_index
    from ..api.query import warn_deprecated_once

    warn_deprecated_once(
        "repro_torch.core.trueknn.trueknn",
        "trueknn() is deprecated; use build_index(points, backend='trueknn')"
        ".query(queries, KnnSpec(k, start_radius=..., stop_radius=...)) and "
        "hold the index across batches",
    )
    index = build_index(
        points,
        backend="trueknn",
        growth=growth,
        max_rounds=max_rounds,
        chunk=chunk,
        seed=seed,
        device=device,
    )
    return index.query(
        queries,
        KnnSpec(int(k), start_radius=start_radius, stop_radius=stop_radius),
    )
