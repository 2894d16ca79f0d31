"""The plain reference: exact k nearest neighbours in plain PyTorch, and
its control in a lower precision.

It imports nothing of the program and takes nothing the program made: it
gets the cloud and the query rows that the benchmark generated and works
the answers out again.  It runs in blocks of query rows, on whatever
device the tensors it is given live on.

``exact_knn`` selects candidates with the expansion |q|^2 + |p|^2 -
2 q.p in float64 (an absolute error near 1e-16 of the squared norms, far
below float32's resolution of a neighbour distance), takes ``k + SPARE``
of them, and ranks those by their distance worked out directly from the
coordinates in float64.  ``control_knn`` is the same search computed in a
lower precision (bfloat16 by default: the coordinates, the expansion and
the ranking), put in the program's place to show that the comparison in
``compare.py`` catches it.
"""

from __future__ import annotations

import torch

__all__ = ["SPARE", "exact_knn", "control_knn", "true_dists"]

#: candidates beyond k that the float64 expansion hands to the direct
#: ranking, so that near-ties at the k-th place are ranked exactly
SPARE = 8


def _blocks(q_total: int, block: int):
    for lo in range(0, q_total, block):
        yield lo, min(lo + block, q_total)


def _expanded_sq(qb: torch.Tensor, pts: torch.Tensor,
                 pn: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances by the expansion, in the inputs' dtype."""
    d2 = torch.addmm(pn[None, :], qb, pts.T, beta=1.0, alpha=-2.0)
    d2.add_((qb * qb).sum(1)[:, None])
    return d2


def true_dists(points: torch.Tensor, queries: torch.Tensor,
               idxs: torch.Tensor) -> torch.Tensor:
    """(Q, m) float64 distances from each query row to the points that
    ``idxs`` (Q, m) names, worked out directly from the coordinates."""
    p = points.double()[idxs.long()]
    diff = p - queries.double()[:, None, :]
    return torch.sqrt((diff * diff).sum(-1))


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int, *,
              exclude=None, block: int = 512):
    """Exact kNN of ``queries`` (Q, d) among ``points`` (N, d), both
    float32.  ``exclude`` (Q,) names for each row a point that is not its
    neighbour (its own id in a self-query), or None.  Returns float64
    distances (Q, k) ascending and int64 indices (Q, k)."""
    pts = points.double()
    pn = (pts * pts).sum(1)
    q_total = queries.shape[0]
    m = min(k + SPARE, pts.shape[0])
    out_d = torch.empty((q_total, k), dtype=torch.float64,
                        device=points.device)
    out_i = torch.empty((q_total, k), dtype=torch.int64, device=points.device)
    for lo, hi in _blocks(q_total, block):
        qb = queries[lo:hi].double()
        d2 = _expanded_sq(qb, pts, pn)
        if exclude is not None:
            rows = torch.arange(hi - lo, device=d2.device)
            d2[rows, exclude[lo:hi].long()] = float("inf")
        _, cand = torch.topk(d2, m, dim=1, largest=False, sorted=False)
        del d2
        exact = true_dists(points, queries[lo:hi], cand)
        if exclude is not None:
            exact[cand == exclude[lo:hi, None].long()] = float("inf")
        # ascending by distance, then by index: a stable sort of the
        # index-sorted candidates
        cand, order = torch.sort(cand, dim=1)
        exact = torch.gather(exact, 1, order)
        exact, order = torch.sort(exact, dim=1, stable=True)
        out_d[lo:hi] = exact[:, :k]
        out_i[lo:hi] = torch.gather(cand, 1, order)[:, :k]
    return out_d, out_i


def control_knn(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                exclude=None, dtype=torch.bfloat16, block: int = 512):
    """The reference's search computed in ``dtype`` throughout: the
    coordinates are rounded to it, and candidates are chosen and ranked by
    the expansion in it.  Returns float32 distances and int64 indices, as
    the program would hand them back."""
    pts = points.to(dtype)
    pn = (pts * pts).sum(1)
    q_total = queries.shape[0]
    out_d = torch.empty((q_total, k), dtype=torch.float32,
                        device=points.device)
    out_i = torch.empty((q_total, k), dtype=torch.int64, device=points.device)
    for lo, hi in _blocks(q_total, block):
        qb = queries[lo:hi].to(dtype)
        d2 = _expanded_sq(qb, pts, pn)
        if exclude is not None:
            rows = torch.arange(hi - lo, device=d2.device)
            d2[rows, exclude[lo:hi].long()] = float("inf")
        val, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        out_d[lo:hi] = torch.sqrt(torch.clamp_min(val.float(), 0.0))
        out_i[lo:hi] = idx
    return out_d, out_i
