"""Start-radius estimation — paper Algorithm 2 (RandomSample), exactly
(port of ``repro.core.sampling``).

Sample ``sample_size`` points with ``numpy.random.default_rng(seed)`` (the
reference's generator, so both packages pick the same rows), find their
``sample_k`` nearest neighbors with the exact brute engine, and return the
*minimum* observed neighbor distance as the start radius.

The two oracle radii of the paper's baselines live here too:
``max_knn_distance`` (maxDist, Sec. 5.2.1) and ``percentile_knn_distance``
(Sec. 5.5.1), each one exact all-points self-query on the brute engine.
"""

from __future__ import annotations

import numpy as np
import torch

from .brute import brute_knn_engine

from .._device import resolve_device

__all__ = ["sample_start_radius", "max_knn_distance", "percentile_knn_distance"]


def sample_start_radius(
    points, *, sample_size: int = 100, sample_k: int = 4, seed: int = 0
) -> float:
    """Paper Alg. 2: min distance among the 4-NN of 100 random points.

    ``points`` is the cloud as a tensor (searched on its device) or an
    array (searched on the CPU)."""
    pts = points if isinstance(points, torch.Tensor) else torch.as_tensor(
        np.asarray(points, np.float32)
    )
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    m = min(sample_size, n)
    sel = rng.choice(n, size=m, replace=False)
    # Exact kNN of the sampled queries against the full dataset; queries are
    # dataset members, so drop the zero-distance self match via k+1.
    kq = min(sample_k + 1, n)
    sel_t = torch.as_tensor(sel, dtype=torch.int64, device=pts.device)
    dists, _, _ = brute_knn_engine(pts, kq, queries=pts[sel_t])
    d = dists.cpu().numpy()[:, 1:]  # drop self column
    d = d[np.isfinite(d) & (d > 0)]
    if d.size == 0:
        return 1e-6
    return float(d.min())


def _kth_column(points, k: int, chunk: int, device) -> np.ndarray:
    """The k-th self-excluded neighbor distance of every point (exact
    brute self-query).  A tensor is searched on its own device, an array
    on ``device``."""
    if isinstance(points, torch.Tensor):
        pts = points
    else:
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=resolve_device(device))
    dists, _, _ = brute_knn_engine(pts, k, chunk=chunk)
    return dists[:, k - 1].cpu().numpy()


def max_knn_distance(points, k: int, *, chunk: int = 1024,
                     device="cuda") -> float:
    """maxDist: max over points of the distance to their k-th neighbor.

    This is the paper's *oracle* baseline radius (Sec. 5.2.1) — the smallest
    fixed radius guaranteed to resolve every query.
    """
    return float(np.max(_kth_column(points, k, chunk, device)))


def percentile_knn_distance(points, k: int, pct: float = 99.0, *,
                            device="cuda") -> float:
    """The paper's 99th-percentile thought-experiment radius (Sec. 5.5.1)."""
    return float(np.percentile(_kth_column(points, k, 512, device), pct))
