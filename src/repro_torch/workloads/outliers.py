"""Statistical outlier removal on a resident index: the Point Cloud
Library's ``StatisticalOutlierRemoval`` filter, as users run it on a
merged LiDAR map before registration and meshing.

``statistical_outlier_removal(index, mean_k, std_mul)`` asks the index
for every point's ``mean_k`` nearest other points in ONE
``AllPairsSpec(mean_k)`` self-query (the planner's self route, unchunked,
so a trueknn index answers through its own self path on its device), and
then, on the host in numpy:

1. ``mean_d[i]``: the float64 sum of row i's ``mean_k`` float32
   distances over ``mean_k``, rounded once to float32 (PCL keeps these
   means as floats too);
2. ``mu`` and ``sigma``: the float64 mean and sample standard deviation
   (n - 1) of ``mean_d`` over the cloud;
3. ``threshold = mu + std_mul * sigma``;
4. ``keep = mean_d <= threshold``, compared in float64.

A point is an outlier when its mean distance to its neighbours lies more
than ``std_mul`` standard deviations above the cloud's mean.  PCL's
tutorial runs ``setMeanK(50)`` and ``setStddevMulThresh(1.0)``.

Departures from PCL:

- PCL asks its search for ``mean_k + 1`` neighbours and skips the first,
  the point itself; here the self route leaves the point out, so the
  ``mean_k`` neighbours are the same set (a duplicate of the point sits
  at distance 0 either way).
- PCL sums the distances in double and computes the variance in one pass
  as ``(sum(x^2) - sum(x)^2 / n) / (n - 1)``; here the variance is
  numpy's two-pass form in float64, the same value up to rounding and
  free of the one-pass form's cancellation.
- PCL skips points whose search fails or whose coordinates are not
  finite; the index here holds finite points only, and every row has
  ``mean_k`` neighbours because the cloud holds more than ``mean_k``
  points.
- PCL's ``setNegative`` and ``setKeepOrganized`` options are not offered:
  ``keep`` is the mask of the inliers and the caller selects.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..api.query import AllPairsSpec
from ..core.result import KNNResult
from ..core.spans import span

__all__ = ["OutlierResult", "statistical_outlier_removal"]


@dataclasses.dataclass
class OutlierResult:
    """The filter's answer.

    keep:      (N,) bool, True for the points kept (the inliers).
    mean_d:    (N,) float32 mean distance of each point to its ``mean_k``
               nearest other points.
    mu / sigma: float64 mean and sample standard deviation of ``mean_d``.
    threshold: ``mu + std_mul * sigma``.
    knn:       the self-query's ``KNNResult``.
    timings:   the search's ``timings`` with the filter's counters added:
               ``sor_filter_seconds`` (the host reduction, threshold and
               mask), ``sor_removed`` (points dropped) and
               ``sor_threshold``.
    """

    keep: np.ndarray
    mean_d: np.ndarray
    mu: float
    sigma: float
    threshold: float
    knn: KNNResult
    timings: dict


def statistical_outlier_removal(index, mean_k: int = 50,
                                std_mul: float = 1.0) -> OutlierResult:
    """Filter ``index``'s resident cloud with PCL's rule (module
    docstring); raises ``ValueError`` for a cloud of at most ``mean_k``
    points."""
    mean_k = int(mean_k)
    std_mul = float(std_mul)
    n = int(index.n_points)
    if n <= mean_k:
        raise ValueError(f"statistical outlier removal needs more than "
                         f"mean_k = {mean_k} points, the index holds {n}")
    knn = index.query(None, AllPairsSpec(mean_k))
    with span("repro_torch.sor.filter"):
        t0 = time.perf_counter()
        sums = np.asarray(knn.dists).sum(axis=1, dtype=np.float64)
        mean_d = (sums / mean_k).astype(np.float32)
        wide = mean_d.astype(np.float64)
        mu = float(wide.mean())
        sigma = float(wide.std(ddof=1))
        threshold = mu + std_mul * sigma
        keep = wide <= threshold
        removed = n - int(np.count_nonzero(keep))
        seconds = time.perf_counter() - t0
    timings = dict(knn.timings)
    timings.update(sor_filter_seconds=seconds, sor_removed=removed,
                   sor_threshold=threshold)
    return OutlierResult(keep=keep, mean_d=mean_d, mu=mu, sigma=sigma,
                         threshold=threshold, knn=knn, timings=timings)
