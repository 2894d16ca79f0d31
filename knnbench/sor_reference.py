"""The filter's rule, for the check of a ``sor_filter`` run: the Point
Cloud Library's statistical outlier removal applied again, in float64, to
what the program returned.  It imports nothing of the program.

PCL's rule on the mean distances ``m`` of the points to their k nearest
other points: the threshold is mean(m) + std_mul * std(m), with the
sample standard deviation (n - 1), and a point is kept when its mean is
at most the threshold.  ``bad_rows`` marks the rows of one batch whose
answer breaks it (the ``sor_filter`` kind counts them as failed, and any
one makes the run read not correct):

- every row whose keep bit differs from the rule applied to the batch's
  returned means; where the returned threshold is off by more than
  ``THRESHOLD_RTOL`` relative from the rule's, every row of the batch;
- every sampled row whose returned mean differs by more than
  ``MEAN_RTOL`` relative from the float64 mean of its own returned list.

Both sums are of float32 values in float64: the program and this rule
differ only by float64 rounding in the threshold (1e-16 relative) and by
one rounding to float32 in a mean (6e-8).  A threshold or a mean worked
out in a lower precision reads far above the limits (``PERF.md``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["THRESHOLD_RTOL", "MEAN_RTOL", "threshold", "bad_rows"]

#: largest relative gap between the returned threshold and the rule's
THRESHOLD_RTOL = 1e-9
#: largest relative gap between a returned mean and its own list's
MEAN_RTOL = 1e-6


def threshold(mean_d, std_mul: float) -> float:
    """mean + std_mul * sample std of ``mean_d``, in float64, two passes."""
    m = np.asarray(mean_d, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        mu = m.sum() / m.size
        var = ((m - mu) ** 2).sum() / (m.size - 1)
        return float(mu + std_mul * np.sqrt(var))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(got - want) / np.abs(want)
    # a gap that cannot be read (inf or nan on either side) is a miss
    return np.where(np.isfinite(gap), gap, np.inf)


def bad_rows(keep, mean_d, got_threshold: float, std_mul: float,
             rows, dists) -> np.ndarray:
    """(N,) bool: the rows of one batch that break the rule.

    ``keep`` (N,) and ``mean_d`` (N,) are the batch's returned decision
    and means, ``got_threshold`` its returned threshold; ``rows`` (R,) the
    sampled rows and ``dists`` (R, k) their returned lists."""
    keep = np.asarray(keep, bool)
    m = np.asarray(mean_d, np.float64)
    want = threshold(m, std_mul)
    if not _rel(got_threshold, want) <= THRESHOLD_RTOL:
        return np.ones(keep.shape, bool)
    bad = keep != (m <= want)
    own = np.asarray(dists, np.float64).mean(axis=1)
    bad[np.asarray(rows)] |= _rel(m[rows], own) > MEAN_RTOL
    return bad
