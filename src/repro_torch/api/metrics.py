"""Pluggable distance metrics for the query surface.

The search engines are Euclidean at heart — grid binning, radius doubling
and the fused pairwise kernel all reason about L2 balls.  Arkade's insight is
that this is not a restriction: many metrics either (a) have a cheap fused
pairwise form the kernels can compute directly (L1 / L∞), or
(b) reduce *exactly* to L2 through a monotone transform of the inputs
(cosine distance: normalize both sides, then ``d_cos = ||q̂ - p̂||² / 2``),
so the whole grid/round machinery keeps operating in transformed space and
only the distances are mapped back at the boundary.

A ``Metric`` records both capabilities:

* ``kernel_name`` — tag the fused engines (``repro_torch.kernels``,
  ``repro_torch.core.brute``) dispatch on; every built-in metric has one.
* ``transform_points`` / ``dist_from_l2`` / ``radius_to_l2`` — the exact
  monotone L2 reduction, when one exists.  The planner uses it to serve a
  non-native metric through an L2-only backend by building a companion
  index over the transformed cloud (grids, warm-start radii and caches all
  live in transformed space — the Arkade trick).

New metrics plug in with ``@register_metric("name")`` over a zero-arg
factory, mirroring the backend registry::

    @register_metric("mahalanobis_diag")
    def _():
        s = 1.0 / np.sqrt(var)          # monotone L2 reduction: scale axes
        return Metric("mahalanobis_diag",
                      pairwise=...,
                      transform_points=lambda x: x * s,
                      dist_from_l2=lambda d: d,
                      radius_to_l2=lambda r: r)

``Metric.pairwise`` is the NumPy *reference form* — float64, O(Q·N) dense —
used by tests and docs as the ground truth; the engines never call it on
the hot path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np

__all__ = [
    "Metric",
    "register_metric",
    "get_metric",
    "available_metrics",
    "normalize_rows",
]


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Unit-normalize rows (float32); zero rows map to zero (their cosine
    distance to everything is then the constant 1 — documented edge)."""
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x.astype(np.float64), axis=-1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Metric:
    """One registered distance.

    pairwise: (Q, d), (N, d) -> (Q, N) float64 reference distances.
    kernel_name: dispatch tag understood by the fused engines ("l2", "l1",
        "linf", "cosine"); None means "reference form only" (the planner
        then requires an L2 reduction).
    transform_points / dist_from_l2 / radius_to_l2: exact monotone L2
        reduction (see module docstring); all three or none.
    """

    name: str
    pairwise: Callable[[np.ndarray, np.ndarray], np.ndarray]
    kernel_name: Optional[str] = None
    transform_points: Optional[Callable[[np.ndarray], np.ndarray]] = None
    dist_from_l2: Optional[Callable[[np.ndarray], np.ndarray]] = None
    radius_to_l2: Optional[Callable[[float], float]] = None

    def __post_init__(self):
        parts = (self.transform_points, self.dist_from_l2, self.radius_to_l2)
        if any(p is not None for p in parts) and any(p is None for p in parts):
            raise ValueError(
                f"metric {self.name!r}: an L2 reduction needs all of "
                "transform_points, dist_from_l2 and radius_to_l2"
            )

    @property
    def has_l2_view(self) -> bool:
        return self.transform_points is not None


_METRICS: Dict[str, Metric] = {}


def register_metric(name: str):
    """Decorator over a zero-arg factory returning a ``Metric``; registers
    the instance under ``name`` and binds it to the decorated symbol.
    Re-registering overwrites (tests/plugins may swap definitions)."""

    def deco(factory) -> Metric:
        m = factory if isinstance(factory, Metric) else factory()
        if not isinstance(m, Metric):
            raise TypeError(
                f"@register_metric({name!r}) needs a Metric or a factory "
                f"returning one, got {type(m).__name__}"
            )
        m = dataclasses.replace(m, name=name)
        _METRICS[name] = m
        return m

    return deco


def get_metric(name) -> Metric:
    if isinstance(name, Metric):
        return name
    try:
        return _METRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; registered: {available_metrics()}"
        ) from None


def available_metrics() -> list:
    return sorted(_METRICS)


# -- built-ins --------------------------------------------------------------


def _diffs(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    return q.astype(np.float64)[:, None, :] - p.astype(np.float64)[None, :, :]


@register_metric("l2")
def _l2() -> Metric:
    return Metric(
        "l2",
        pairwise=lambda q, p: np.sqrt((_diffs(q, p) ** 2).sum(-1)),
        kernel_name="l2",
        # trivially its own L2 view (identity) — lets the planner treat
        # "has_l2_view" uniformly if it ever needs to.
        transform_points=lambda x: np.asarray(x, np.float32),
        dist_from_l2=lambda d: d,
        radius_to_l2=lambda r: r,
    )


@register_metric("l1")
def _l1() -> Metric:
    # No exact global L2 reduction exists for L1 (the ball is a cross-
    # polytope); engines compute it directly in the pairwise kernel.
    return Metric(
        "l1",
        pairwise=lambda q, p: np.abs(_diffs(q, p)).sum(-1),
        kernel_name="l1",
    )


@register_metric("linf")
def _linf() -> Metric:
    return Metric(
        "linf",
        pairwise=lambda q, p: np.abs(_diffs(q, p)).max(-1),
        kernel_name="linf",
    )


@register_metric("cosine")
def _cosine() -> Metric:
    # d_cos(q, p) = 1 - q·p / (|q||p|) ∈ [0, 2].  On unit-normalized rows
    # ||q̂ - p̂||² = 2 - 2 q̂·p̂ = 2 d_cos, so the L2 engines serve cosine
    # exactly: transform = normalize, d_cos = ℓ²/2, r_ℓ2 = sqrt(2 r_cos).
    def pw(q, p):
        qn = normalize_rows(q).astype(np.float64)
        pn = normalize_rows(p).astype(np.float64)
        return np.clip(1.0 - qn @ pn.T, 0.0, 2.0)

    return Metric(
        "cosine",
        pairwise=pw,
        kernel_name="cosine",
        transform_points=normalize_rows,
        dist_from_l2=lambda d: np.square(d) * 0.5,
        radius_to_l2=lambda r: math.sqrt(2.0 * min(float(r), 2.0)),
    )
