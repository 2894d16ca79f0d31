"""Plain PyTorch version of the ``pairwise_topk`` kernel.

Same function as ``csrc/pairwise_topk.cu`` in the same float forms, so on
one device the two agree bitwise wherever ``torch.addcmul`` is a fused
multiply-add (the L2 forms) and always for L1 / L∞:

* L2, d <= 8: ``acc = x0*x0`` then ``acc = addcmul(acc, xa, xa)`` with
  ``xa = q_a - p_a`` — the FMA chain XLA compiles the JAX reference's
  ``sum(diff * diff)`` to, hence bitwise equal to ``repro``'s brute engine
  on the CPU;
* L2, d > 8: ``max((qn + pn) - 2 q.p, 0)`` with every term an FMA chain;
* L2 diff (``"l2diff"``): the d <= 8 L2 chain at any d — the placed
  shard fabric's squared-L2 form (the reference's ``sum(diff * diff)``);
* L1: sequential ``|q_a - p_a|`` sum; L∞: running max.

Ties go to the lowest index (a stable sort, never ``torch.topk``), slots
past the finite candidates are ``(inf, n)``, and the self index
``query_ids[i]`` (``n`` = none) is excluded.  The wrapper in ``ops.py``
runs this for tensors on the CPU; on the card it is the yardstick the
kernel is held against.  ``merge_partial_topk`` is the plain version of
the kernel's merge pass: per row, the partial lists of S contiguous point
ranges combined into the list of the whole.
"""

from __future__ import annotations

import math

import torch

__all__ = ["pairwise_topk_ref", "merge_partial_topk", "pairwise_dists",
           "sq_norm"]

LOW_D = 8  # real feature dims at or below which L2 takes the diff form
_CHUNK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, N) block per step


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms as an FMA chain over the feature axis."""
    acc = x[:, 0] * x[:, 0]
    for a in range(1, x.shape[1]):
        acc = torch.addcmul(acc, x[:, a], x[:, a])
    return acc


def pairwise_dists(q: torch.Tensor, p: torch.Tensor, metric: str):
    """(m, N) distances in the kernel's forms: squared for ``"l2"`` and
    ``"l2diff"``, raw for ``"l1"`` / ``"linf"``."""
    d = q.shape[1]
    if metric == "l2" and d > LOW_D:
        cross = q[:, None, 0] * p[None, :, 0]
        for a in range(1, d):
            cross = torch.addcmul(cross, q[:, None, a], p[None, :, a])
        return torch.clamp_min(
            (sq_norm(q)[:, None] + sq_norm(p)[None, :]) - 2.0 * cross, 0.0
        )
    sq = metric in ("l2", "l2diff")
    diff = q[:, None, 0] - p[None, :, 0]
    acc = diff * diff if sq else diff.abs()
    for a in range(1, d):
        diff = q[:, None, a] - p[None, :, a]
        if sq:
            acc = torch.addcmul(acc, diff, diff)
        elif metric == "l1":
            acc = acc + diff.abs()
        elif metric == "linf":
            acc = torch.maximum(acc, diff.abs())
        else:
            raise ValueError(f"pairwise_topk: unsupported metric {metric!r}")
    return acc


def pairwise_topk_ref(
    queries,
    points,
    k: int,
    *,
    radius2: float = math.inf,
    query_ids=None,
    metric: str = "l2",
    row_mask=None,
    out=None,
    chunk: int = 0,
):
    """k smallest distances per query, their indices and the in-radius
    counts.

    queries (Q, D) f32 and points (N, D) f32 on one device; ``radius2`` is
    the kernel-space threshold (squared for l2, raw for l1/linf);
    ``query_ids`` (Q,) int32 names each query's self index (N: none).
    ``row_mask`` (Q,) uint8 restricts the work to rows where it is set;
    ``out`` = (d (Q, k), idx (Q, k), counts (Q,)) receives the rows
    computed (fresh tensors when None).  ``chunk`` caps the rows per
    distance block (0: sized from N).  Returns ``out``.
    """
    q, p = queries, points
    nq, n = q.shape[0], p.shape[0]
    dev = q.device
    if out is None:
        out = (
            torch.full((nq, k), math.inf, dtype=torch.float32, device=dev),
            torch.full((nq, k), n, dtype=torch.int32, device=dev),
            torch.zeros((nq,), dtype=torch.int32, device=dev),
        )
    od, oi, oc = out
    if query_ids is None:
        query_ids = torch.full((nq,), n, dtype=torch.int32, device=dev)
    rows = (
        torch.arange(nq, device=dev)
        if row_mask is None
        else torch.nonzero(row_mask).flatten()
    )
    step = max(1, _CHUNK_ELEMS[dev.type] // max(n, 1))
    if chunk:
        step = min(step, int(chunk))
    kk = min(k, n)
    cols = torch.arange(n, device=dev)
    for i0 in range(0, rows.numel(), step):
        r = rows[i0:i0 + step]
        dist = pairwise_dists(q[r], p, metric)
        keep = cols[None, :] != query_ids[r].to(torch.int64)[:, None]
        dist = torch.where(keep, dist, math.inf)
        oc[r] = ((dist <= radius2) & keep).sum(1, dtype=torch.int32)
        sd, si = torch.sort(dist, dim=1, stable=True)
        sd, si = sd[:, :kk], si[:, :kk]
        fin = torch.isfinite(sd)
        sd = torch.where(fin, sd, math.inf)
        si = torch.where(fin, si, n).to(torch.int32)
        if kk < k:
            pad = (sd.shape[0], k - kk)
            sd = torch.cat([sd, sd.new_full(pad, math.inf)], 1)
            si = torch.cat([si, si.new_full(pad, n)], 1)
        od[r] = sd
        oi[r] = si
    return out


def merge_partial_topk(part_d, part_i, part_c, k: int, n: int, *,
                       row_mask=None, out=None):
    """Merge per-range partial results into whole-cloud ones.

    ``part_d`` / ``part_i`` (S, Q, k') and ``part_c`` (S, Q) are the
    outputs of S runs over contiguous, increasing ranges of the N points,
    indices already global, each list ordered by (distance, index) with
    empty slots (inf, n).  Per row the S lists are merged in range order
    (a stable sort over the lists laid end to end, so the earlier range
    wins a tie: the global lowest-index order) and the counts summed in
    int32.  ``row_mask`` / ``out`` as in ``pairwise_topk_ref``.  Returns
    ``out``.
    """
    s_, nq = part_c.shape
    dev = part_d.device
    if out is None:
        out = (
            torch.full((nq, k), math.inf, dtype=torch.float32, device=dev),
            torch.full((nq, k), n, dtype=torch.int32, device=dev),
            torch.zeros((nq,), dtype=torch.int32, device=dev),
        )
    od, oi, oc = out
    rows = (
        torch.arange(nq, device=dev)
        if row_mask is None
        else torch.nonzero(row_mask).flatten()
    )
    cand_d = part_d[:, rows].permute(1, 0, 2).reshape(rows.numel(), -1)
    cand_i = part_i[:, rows].permute(1, 0, 2).reshape(rows.numel(), -1)
    kk = min(k, cand_d.shape[1])
    sd, arg = torch.sort(cand_d, dim=1, stable=True)
    sd, arg = sd[:, :kk], arg[:, :kk]
    si = torch.gather(cand_i, 1, arg)
    fin = torch.isfinite(sd)
    sd = torch.where(fin, sd, math.inf)
    si = torch.where(fin, si, n).to(torch.int32)
    if kk < k:
        pad = (sd.shape[0], k - kk)
        sd = torch.cat([sd, sd.new_full(pad, math.inf)], 1)
        si = torch.cat([si, si.new_full(pad, n)], 1)
    od[rows] = sd
    oi[rows] = si
    oc[rows] = part_c[:, rows].sum(0, dtype=torch.int32)
    return out
