"""The comparison that decides ``correct``: the program's answers against
the plain reference's, number by number, each beside its limit.

The configurations state exact kNN in float32: each row's k distances
are the k smallest distances from the query to the cloud (the query's own
point left out of a self-query), and each index names a point at the
distance reported beside it.  Two numbers are compared:

- ``dist_rel_err``: the largest gap, over the rows checked and the k
  places, between the program's sorted distances and the reference's
  exact ones, relative to the reference's.  A missed neighbour, a row
  answered for another query, or a list cut short (``inf``) reads far
  above float32's rounding.
- ``idx_rel_err``: the largest gap between a distance the program reports
  and the exact distance to the point its index names, relative to the
  latter; an index out of range, twice in a row or the excluded point
  reads ``inf``.  Ties may be broken either way: a tied neighbour is at
  the reported distance all the same.

The limits come from readings on the chip at the cells' own sizes, as
``PERF.md`` sets out: the program's float32 arithmetic reads 1.1e-7 to
1.5e-7 on every seed; the control (``reference.control_knn``, the search
in bfloat16, and in float32 with TF32 matmuls) reads 1.0 and above.  The
limit sits between, nearer the upper in log terms.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["LIMITS", "TINY", "compare_rows", "judge", "checks_line"]

#: number -> the largest value that a correct run may read
LIMITS = {
    "dist_rel_err": 1e-3,
    "idx_rel_err": 1e-3,
}

#: floor of a relative error's denominator (duplicate points sit at 0)
TINY = 1e-30


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not got.size:
        return 0.0
    bad = ~np.isfinite(got) & np.isfinite(want)
    if bad.any():
        return math.inf
    with np.errstate(invalid="ignore"):
        gap = np.abs(got - want) / np.maximum(np.abs(want), TINY)
    gap = np.where(np.isfinite(want) | np.isfinite(got), gap, 0.0)
    if np.isnan(gap).any():
        return math.inf
    return float(gap.max())


def compare_rows(port_d, port_i, ref_d, true_at_port, n_points: int,
                 exclude=None) -> dict:
    """The two gaps over a block of checked rows.

    ``port_d`` (R, k) float32 and ``port_i`` (R, k): the program's answer;
    ``ref_d`` (R, k): the reference's exact distances, ascending;
    ``true_at_port`` (R, k): the exact distance from each row to the point
    that ``port_i`` names (the reference works it out; any value where the
    index is out of range); ``exclude`` (R,): each row's excluded id, or
    None."""
    port_d = np.asarray(port_d, np.float32)
    port_i = np.asarray(port_i, np.int64)
    dist = _rel(np.sort(port_d, axis=1), ref_d)
    valid = (port_i >= 0) & (port_i < n_points)
    if exclude is not None:
        valid &= port_i != np.asarray(exclude, np.int64)[:, None]
    srt = np.sort(port_i, axis=1)
    valid_rows = valid.all(1) & (np.diff(srt, axis=1) != 0).all(1)
    idx = math.inf if not valid_rows.all() else _rel(port_d, true_at_port)
    return {"dist_rel_err": dist, "idx_rel_err": idx}


def judge(numbers: dict) -> bool:
    """True when every number is at or under its limit."""
    return all(numbers[name] <= LIMITS[name] for name in LIMITS)


def _plain(x):
    return x if math.isfinite(x) else ("inf" if x > 0 else "-inf")


def checks_line(numbers: dict) -> dict:
    """The compared numbers as the result line carries them: each name
    with its value and its limit."""
    return {name: {"value": _plain(float(numbers[name])),
                   "limit": LIMITS[name]} for name in LIMITS}
