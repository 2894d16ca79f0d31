"""The plain reference of statistical outlier removal (the Point Cloud
Library's ``StatisticalOutlierRemoval``), in plain ``torch`` float64.

A blocked brute self kNN that leaves each point itself out, then PCL's
rule on its lists: each point's mean distance to its k nearest other
points, the mean and sample standard deviation (n - 1) of those means,
and a point kept when its mean is at most mean + std_mul * std.

Candidates are chosen by the expansion |q|^2 + |p|^2 - 2 q.p in float64
(``SPARE`` beyond k), then ranked by their distance worked out directly
from the coordinates in float64.  It runs on the device of the points it
is given and imports nothing of the program.  TF32 matmuls are turned
off, so a float32 matmul elsewhere in the process is not rounded to TF32
on a card either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["SPARE", "PlainSor", "self_knn_dists", "sor"]

#: candidates beyond k handed from the expansion to the direct ranking
SPARE = 8


@dataclasses.dataclass
class PlainSor:
    keep: np.ndarray  # (N,) bool
    mean_d: np.ndarray  # (N,) float64
    mu: float
    sigma: float
    threshold: float


def self_knn_dists(points, k: int, *, block: int = 1024,
                   device=None) -> torch.Tensor:
    """(N, k) float64 distances, ascending, from each point to its k
    nearest other points."""
    pts = torch.as_tensor(np.asarray(points)).to(device or "cpu").double()
    n = pts.shape[0]
    if n <= k:
        raise ValueError(f"need more than k = {k} points, got {n}")
    m = min(k + SPARE, n - 1)
    pn = (pts * pts).sum(1)
    out = torch.empty((n, k), dtype=torch.float64, device=pts.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        qb = pts[lo:hi]
        rows = torch.arange(hi - lo, device=pts.device)
        d2 = torch.addmm(pn[None, :], qb, pts.T, beta=1.0, alpha=-2.0)
        d2.add_(pn[lo:hi, None])
        d2[rows, lo + rows] = float("inf")
        cand = torch.topk(d2, m, dim=1, largest=False, sorted=False).indices
        del d2
        diff = pts[cand] - qb[:, None, :]
        exact = torch.sqrt((diff * diff).sum(-1))
        exact[cand == (lo + rows)[:, None]] = float("inf")
        out[lo:hi] = torch.sort(exact, dim=1).values[:, :k]
    return out


def sor(points, k: int = 50, std_mul: float = 1.0, *, block: int = 1024,
        device=None) -> PlainSor:
    """PCL's statistical outlier removal of ``points`` at ``mean_k`` =
    ``k`` and ``stddev_mul`` = ``std_mul``."""
    d = self_knn_dists(points, k, block=block, device=device)
    mean_d = d.mean(1)
    mu = mean_d.mean()
    sigma = mean_d.std(correction=1)
    threshold = mu + std_mul * sigma
    return PlainSor(keep=(mean_d <= threshold).cpu().numpy(),
                    mean_d=mean_d.cpu().numpy(), mu=float(mu),
                    sigma=float(sigma), threshold=float(threshold))
