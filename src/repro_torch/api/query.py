"""Typed query specifications — the one planned query surface.

The backend registry says *who* answers a search; this module
unifies *what* is being asked.  Every ``NeighborIndex.query`` call takes a
``QuerySpec`` describing the search shape, and the planner
(``repro_torch.api.planner``) routes it to a backend's native ``execute_*`` hook
or to a generic plan.  Three shapes cover the RT-search literature this
repo reproduces:

* ``KnnSpec(k)`` — the paper's unbounded kNN (TrueKNN): grow the radius
  until every query has k neighbors.  ``start_radius`` seeds the schedule,
  ``stop_radius`` is the Sec. 5.5.1 early termination (tail queries keep
  partial lists).
* ``RangeSpec(radius)`` — fixed-radius / range search (RTNN's sibling
  workload): *all* neighbors within the ball, returned as a ragged
  ``RangeResult`` in CSR layout.  ``max_neighbors`` truncates each row to
  the nearest m (the RTNN "bounded buffer" regime).
* ``HybridSpec(k, radius)`` — kNN truncated at a radius cap: exact k
  nearest, except neighbors beyond ``radius`` are never reported (queries
  in sparse regions come back with ``found < k``).

Specs are frozen dataclasses: hashable, printable, safe to reuse across
batches and to ship between processes.  Metric selection is orthogonal —
``index.query(q, spec, metric="l1")`` — see ``repro_torch.api.metrics``.

This module also owns the once-per-process deprecation machinery for the
deprecated call forms (``query(q, k=...)`` and the free-function shims
``trueknn``, ``brute_knn``, ``fixed_radius_knn``).  A host-side copy of
``repro.api.query``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import warnings
from typing import ClassVar, Optional

__all__ = [
    "QuerySpec",
    "KnnSpec",
    "RangeSpec",
    "HybridSpec",
    "AllPairsSpec",
    "warn_deprecated_once",
]


def _check_pos_int(name: str, v) -> int:
    if not isinstance(v, (int,)) or isinstance(v, bool) or v < 1:
        raise ValueError(f"{name} must be a positive int, got {v!r}")
    return int(v)


def _check_pos_float(name: str, v) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a positive finite float, got {v!r}")
    if not (f > 0.0) or f != f or f == float("inf"):
        raise ValueError(f"{name} must be a positive finite float, got {v!r}")
    return f


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Base of the spec family.  Subclasses are frozen value objects; all
    validation that needs only the spec itself happens in ``__post_init__``,
    index-dependent validation (k vs N) in the planner."""

    kind: ClassVar[str] = "?"

    def validate(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class KnnSpec(QuerySpec):
    """k nearest neighbors, search space unbounded (paper Alg. 3).

    start_radius: explicit first search radius (None: backend decides —
        warm-start EMA, then paper Alg. 2 sampling).  Backend-defined for
        engines without a radius schedule (brute post-filters).
    stop_radius: terminate radius growth at this bound; tail queries keep
        the partial (< k) lists they found (paper Sec. 5.5.1).
    """

    k: int
    start_radius: Optional[float] = None
    stop_radius: Optional[float] = None
    kind: ClassVar[str] = "knn"

    def __post_init__(self):
        object.__setattr__(self, "k", _check_pos_int("k", self.k))
        if self.start_radius is not None:
            object.__setattr__(
                self, "start_radius",
                _check_pos_float("start_radius", self.start_radius),
            )
        if self.stop_radius is not None:
            object.__setattr__(
                self, "stop_radius",
                _check_pos_float("stop_radius", self.stop_radius),
            )
        if (
            self.start_radius is not None
            and self.stop_radius is not None
            and self.start_radius > self.stop_radius
        ):
            raise ValueError(
                f"start_radius ({self.start_radius}) must not exceed "
                f"stop_radius ({self.stop_radius})"
            )

    def validate(self) -> None:
        pass  # __post_init__ already ran


@dataclasses.dataclass(frozen=True)
class RangeSpec(QuerySpec):
    """All neighbors within ``radius`` (RTNN-style range search).

    Answers are ragged; the result is a ``RangeResult`` in CSR layout
    (``offsets``/``idxs``/``dists``), each row sorted nearest-first.
    ``max_neighbors`` caps each row at the nearest m (``result.truncated``
    marks rows that hit the cap).
    """

    radius: float
    max_neighbors: Optional[int] = None
    kind: ClassVar[str] = "range"

    def __post_init__(self):
        object.__setattr__(
            self, "radius", _check_pos_float("radius", self.radius)
        )
        if self.max_neighbors is not None:
            object.__setattr__(
                self, "max_neighbors",
                _check_pos_int("max_neighbors", self.max_neighbors),
            )

    def validate(self) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class HybridSpec(QuerySpec):
    """k nearest neighbors, truncated at a radius cap.

    Exactly ``KnnSpec(k)`` with every neighbor farther than ``radius``
    dropped: dense (Q, k) output, inf/sentinel-padded where the ball holds
    fewer than k points.  The serving shape for "top-k but never return
    garbage matches".

    ``found`` contract: ``found[i] >= k`` iff all k slots are in-ball
    (query resolved).  Its exact value past that is backend-defined — a
    multi-round engine reports the count seen at the radius that resolved
    the query, a single-round engine the full cap-ball population, the
    dense plans a count capped at k.  Need the true ball population?  Ask
    ``RangeSpec`` — that's what its counter is for.
    """

    k: int
    radius: float
    kind: ClassVar[str] = "hybrid"

    def __post_init__(self):
        object.__setattr__(self, "k", _check_pos_int("k", self.k))
        object.__setattr__(
            self, "radius", _check_pos_float("radius", self.radius)
        )

    def validate(self) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class AllPairsSpec(QuerySpec):
    """The dataset queries itself — the kNN-graph / clustering workload.

    Queries are the index's own resident points, so the planner routes
    this through the self-query path every backend already has (qid-based
    self-exclusion, ``strip_self_knn``/``strip_self_csr``) instead of
    treating the cloud as a foreign batch.  Two modes:

    * ``mode="knn"`` — each point's k nearest *other* points (the kNN-graph
      edge set).  Dense ``(N, k)`` KNNResult.
    * ``mode="range"`` — each point's neighbors within ``radius``,
      excluding itself (the DBSCAN eps-neighborhood).  Ragged CSR
      ``RangeResult``; the ``d == radius`` boundary is inclusive, the same
      ``<=`` form as ``RangeSpec``.

    ``chunk_rows`` bounds how many self-rows run per dispatch: million-row
    clouds stream through the prepared-plan executable cache in equal
    fixed-shape blocks rather than one monolithic batch.  Chunked and
    unchunked execution return bit-identical answers (every backend is
    exact with the (dist, id) lexicographic tie-break, so the final rows
    are the unique answer regardless of internal batching).
    """

    k: Optional[int] = None
    mode: str = "knn"
    radius: Optional[float] = None
    chunk_rows: Optional[int] = None
    kind: ClassVar[str] = "all_pairs"

    def __post_init__(self):
        if self.mode not in ("knn", "range"):
            raise ValueError(
                f"mode must be 'knn' or 'range', got {self.mode!r}"
            )
        if self.mode == "knn":
            if self.radius is not None:
                raise ValueError("mode='knn' takes k, not radius")
            object.__setattr__(self, "k", _check_pos_int("k", self.k))
        else:
            if self.k is not None:
                raise ValueError("mode='range' takes radius, not k")
            object.__setattr__(
                self, "radius", _check_pos_float("radius", self.radius)
            )
        if self.chunk_rows is not None:
            object.__setattr__(
                self, "chunk_rows",
                _check_pos_int("chunk_rows", self.chunk_rows),
            )

    def lowered(self) -> QuerySpec:
        """The ordinary spec a self-batch of this spec answers with."""
        if self.mode == "knn":
            return KnnSpec(self.k)
        return RangeSpec(self.radius)

    def validate(self) -> None:
        pass


# -- once-per-process deprecation registry ---------------------------------

_WARNED: set = set()

#: root of the ``repro_torch`` package; frames under it are library
#: internals the warning must never be attributed to
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caller_stacklevel() -> int:
    """The ``warnings.warn`` stacklevel of the nearest frame *outside* the
    ``repro_torch`` package.

    A fixed stacklevel is only right for one call depth: the moment a
    deprecated form is reached through another layer of the package (a
    server batch, a companion view, a shim over a shim) the warning would
    land on library internals.  Walking the stack out of the package pins
    it on the migrating caller's code at every depth.  The separator after
    the root keeps a sibling directory whose name starts with it (such as
    ``repro_torch_x``) outside.  (From ``warnings.warn``'s point of view
    level 1 is our caller's frame, hence the offset.)
    """
    # sys._getframe(1) is warn_deprecated_once's own frame — exactly what
    # warnings.warn (called from there) numbers as stacklevel 1, so the
    # counter below shares warnings.warn's numbering.
    level = 1
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.startswith(
        _PKG_ROOT + os.sep
    ):
        f = f.f_back
        level += 1
    return level


def warn_deprecated_once(
    key: str, message: str, *, stacklevel: Optional[int] = None
) -> None:
    """Emit ``DeprecationWarning`` for ``key`` at most once per process,
    attributed to the caller *outside* this package (so ``python -W
    error::DeprecationWarning`` and log lines point at the code that needs
    migrating, not at the shim).  Pass ``stacklevel`` only to override the
    automatic stack walk.

    Own registry (not ``warnings``' built-in "once") so the behavior is
    independent of whatever filters the host application or pytest
    installed.  Tests reset via ``_reset_deprecation_registry``.
    """
    if key in _WARNED:
        return
    _WARNED.add(key)
    if stacklevel is None:
        stacklevel = _caller_stacklevel()
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def _reset_deprecation_registry() -> None:
    """Test hook: make the next ``warn_deprecated_once`` fire again."""
    _WARNED.clear()
