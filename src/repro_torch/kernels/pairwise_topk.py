"""Wrapper of the hand-written CUDA ``pairwise_topk`` kernel.

The kernel (``csrc/pairwise_topk.cu``) replaces the Pallas TPU kernel
``repro/kernels/pairwise_topk.py::_kernel``: fused pairwise distances, a
streaming exact top-k and an in-radius count, with the (Q, N) distance
matrix never materialized.  Its plain PyTorch version is
``repro_torch.kernels.ref.pairwise_topk_ref``; ``ops.topk_engine`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import torch

from .build import count_launch, extension

__all__ = ["pairwise_topk_cuda", "METRIC_IDS"]

METRIC_IDS = {"l2": 0, "l1": 1, "linf": 2}


def pairwise_topk_cuda(
    queries: torch.Tensor,
    query_ids: torch.Tensor,
    points: torch.Tensor,
    thr: float,
    *,
    k: int,
    metric: str = "l2",
    row_mask=None,
    out=None,
):
    """Launch the kernel: (d (Q, k) f32, idx (Q, k) i32, counts (Q,) i32).

    ``thr`` is the kernel-space threshold (squared radius for l2, raw for
    l1/linf).  ``row_mask`` (Q,) uint8 skips rows where it is 0 and leaves
    their slots of ``out`` untouched.  Every tensor must be contiguous and
    on one CUDA device; anything else raises.
    """
    if metric not in METRIC_IDS:
        raise ValueError(f"pairwise_topk: unsupported metric {metric!r}")
    q, qid, p = queries, query_ids, points
    dev = p.device
    if dev.type != "cuda":
        raise ValueError("pairwise_topk_cuda needs CUDA tensors")
    nq, d = q.shape
    n = p.shape[0]
    k = int(k)
    if out is None:
        out = (
            torch.empty((nq, k), dtype=torch.float32, device=dev),
            torch.empty((nq, k), dtype=torch.int32, device=dev),
            torch.empty((nq,), dtype=torch.int32, device=dev),
        )
    od, oi, oc = out
    for t, dtype, shape in (
        (q, torch.float32, (nq, d)),
        (p, torch.float32, (n, d)),
        (qid, torch.int32, (nq,)),
        (od, torch.float32, (nq, k)),
        (oi, torch.int32, (nq, k)),
        (oc, torch.int32, (nq,)),
        (row_mask, torch.uint8, (nq,)),
    ):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"pairwise_topk: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("pairwise_topk: tensors must be contiguous")
    if n < 1 or d < 1 or k < 1:
        raise ValueError(f"pairwise_topk: needs n, d, k >= 1 (got {n}, {d}, {k})")
    if nq == 0:
        return out
    extension().pairwise_topk(q, qid, p, row_mask, k, float(thr),
                              METRIC_IDS[metric], od, oi, oc)
    count_launch("pairwise_topk")
    return out
