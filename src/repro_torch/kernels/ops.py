"""User-facing wrappers of the ``pairwise_topk`` kernel.

``topk_engine`` is the kernel-level call: the CUDA kernel for tensors on
the card, its plain PyTorch version (``ref.pairwise_topk_ref``) for
tensors on the CPU — chosen by the device of the tensors it is given,
never as a fallback from a failed launch.  ``pairwise_topk`` adds the
metric forms of ``repro.kernels.ops.pairwise_topk``: radius -> threshold,
and cosine as normalize, L2, then x0.5.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .pairwise_topk import pairwise_topk_cuda
from .ref import pairwise_topk_ref, sq_norm

__all__ = ["pairwise_topk", "topk_engine", "l2_normalize", "as_f32", "sqrt32"]


def as_f32(x, device) -> torch.Tensor:
    """``x`` (array or tensor) as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  PyTorch's vectorized CPU
    ``sqrt`` is not (about 0.5 ulp, off by one ulp on some inputs); the
    square root taken in float64 and rounded once to float32 is, on every
    device, so the values equal the reference's IEEE ``sqrt``."""
    return torch.sqrt(x.double()).float()


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize rows, 1e-12 floor on the norm (the device-side twin
    of ``api.metrics.normalize_rows``)."""
    n = sqrt32(sq_norm(x))[:, None]
    return x / torch.clamp_min(n, 1e-12)


def topk_engine(queries, query_ids, points, thr: float, *, k: int,
                metric: str = "l2", row_mask=None, out=None, chunk: int = 0):
    """(d (Q, k), idx (Q, k), counts (Q,)) on the tensors' own device: the
    CUDA kernel on the card, the plain version on the CPU."""
    if points.device.type == "cuda":
        return pairwise_topk_cuda(
            queries, query_ids, points, thr, k=k, metric=metric,
            row_mask=row_mask, out=out,
        )
    return pairwise_topk_ref(
        queries, points, k, radius2=thr, query_ids=query_ids, metric=metric,
        row_mask=row_mask, out=out, chunk=chunk,
    )


def pairwise_topk(
    queries,
    points,
    k: int,
    *,
    radius: float = math.inf,
    query_ids=None,
    metric: str = "l2",
):
    """Exact k smallest distances from each query to the point set, plus
    the count of points within ``radius`` (metric units).

    Runs where ``points`` lives (a tensor's device; arrays go to the CPU).
    Returns (d (Q, k) f32, idx (Q, k) i32, counts (Q,) i32) tensors, rows
    nearest-first.  ``d`` is SQUARED for ``metric="l2"`` and the true
    metric distance otherwise; ``idx`` is N for empty slots;
    ``query_ids`` (Q,) excludes one self index per query.
    """
    dev = points.device if isinstance(points, torch.Tensor) else "cpu"
    q = as_f32(queries, dev)
    p = as_f32(points, dev)
    n = p.shape[0]
    if p.shape[1] != q.shape[1]:
        raise ValueError(f"dims differ: queries {q.shape}, points {p.shape}")
    r = float(radius)
    if metric == "cosine":
        # exact monotone L2 reduction: normalize, search L2, map back;
        # d_cos <= r  <=>  ||q̂-p̂||² <= 2r, and cosine distance caps at 2
        q = l2_normalize(q)
        p = l2_normalize(p)
        kernel_metric = "l2"
        thr = 2.0 * min(r, 2.0) if np.isfinite(r) else math.inf
    elif metric in ("l1", "linf"):
        kernel_metric = metric
        thr = r
    elif metric == "l2":
        kernel_metric = "l2"
        thr = float(np.float32(r) ** 2) if np.isfinite(r) else math.inf
    else:
        raise ValueError(f"pairwise_topk: unsupported metric {metric!r}")
    if query_ids is None:
        qid = torch.full((q.shape[0],), n, dtype=torch.int32, device=dev)
    else:
        qid = torch.as_tensor(query_ids, dtype=torch.int32, device=dev)
    d_out, idx, counts = topk_engine(
        q, qid.contiguous(), p, thr, k=int(k), metric=kernel_metric
    )
    if metric == "cosine":
        d_out = d_out * 0.5  # squared L2 on normalized rows -> cosine dist
    return d_out, idx, counts
