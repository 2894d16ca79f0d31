"""Start-radius estimation — paper Algorithm 2 (RandomSample), exactly
(port of ``repro.core.sampling``).

Sample ``sample_size`` points with ``numpy.random.default_rng(seed)`` (the
reference's generator, so both packages pick the same rows), find their
``sample_k`` nearest neighbors with the exact brute engine, and return the
*minimum* observed neighbor distance as the start radius.
"""

from __future__ import annotations

import numpy as np
import torch

from .brute import brute_knn_engine

__all__ = ["sample_start_radius"]


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
