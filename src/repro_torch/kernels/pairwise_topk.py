"""Wrapper of the hand-written CUDA ``pairwise_topk`` kernel.

The kernel (``csrc/pairwise_topk.cu``) replaces the Pallas TPU kernel
``repro/kernels/pairwise_topk.py::_kernel``: fused pairwise distances, a
streaming exact top-k and an in-radius count, with the (Q, N) distance
matrix never materialized.  It runs in two passes: S blocks per query
tile each scan one contiguous range of the points into a partial list,
and a merge pass combines each row's S lists (``choose_splits`` picks S
from the first pass's rows a block, which the extension reports).  Both
passes keep each list with a whole warp: up to k = 1024 in registers
spread over its lanes, above in the row of memory the list is written to.
The first pass serves 4, 2 or 1 queries a warp (16, 8 or 4 rows a block
of four warps), the merge a row a warp.
Its plain PyTorch version is ``repro_torch.kernels.ref.pairwise_topk_ref``
(and ``ref.merge_partial_topk`` for the merge); ``ops.topk_engine`` picks
between kernel and plain version by the tensors' device.
"""

from __future__ import annotations

import functools

import torch

from .build import count_launch, extension

__all__ = ["pairwise_topk_cuda", "choose_splits", "split_plan", "METRIC_IDS"]

METRIC_IDS = {"l2": 0, "l1": 1, "linf": 2, "l2diff": 3}

BLOCKS_PER_SM = 4  # blocks in flight per SM that the split aims for
MIN_SPAN = 256  # fewest points a range of the split scans
WORKSPACE_BYTES = 1 << 28  # most partial-list workspace one call takes


def choose_splits(nq: int, n: int, k: int, sms: int, per_block: int):
    """(S, span): the number of point ranges the first pass splits the N
    points into, and the points per range (the last range may be shorter,
    none is empty).  S fills ``BLOCKS_PER_SM`` blocks of ``per_block``
    queries on each of ``sms`` SMs, with no range under ``MIN_SPAN``
    points and the (S, Q, k) workspace under ``WORKSPACE_BYTES``."""
    tiles = -(-nq // per_block)
    s = max(1, -(-(BLOCKS_PER_SM * sms) // tiles))
    s = min(s, max(1, n // MIN_SPAN),
            max(1, WORKSPACE_BYTES // max(1, nq * k * 8)))
    span = -(-n // s)
    return -(-n // span), span


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _rows_per_block(d: int, k: int, metric: str) -> int:
    """Query rows one block of the first pass serves, as the kernel's own
    launcher computes it."""
    return extension().pairwise_topk_rows_per_block(d, k, METRIC_IDS[metric])


def split_plan(nq: int, n: int, d: int, k: int, metric: str, device):
    """(S, span) of a call with these shapes on the CUDA ``device``."""
    return choose_splits(nq, n, k, _sm_count(device.index or 0),
                         _rows_per_block(d, k, metric))


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

    ``thr`` is the kernel-space threshold (squared radius for l2 and
    l2diff, raw for l1/linf).  ``row_mask`` (Q,) uint8 skips rows where it is 0 and leaves
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
    splits, span = split_plan(nq, n, d, k, metric, dev)
    if splits == 1:  # the first pass writes the outputs
        part = out
    else:
        part = (
            torch.empty((splits, nq, k), dtype=torch.float32, device=dev),
            torch.empty((splits, nq, k), dtype=torch.int32, device=dev),
            torch.empty((splits, nq), dtype=torch.int32, device=dev),
        )
    ext = extension()
    ext.pairwise_topk(q, qid, p, row_mask, k, splits, span, float(thr),
                      METRIC_IDS[metric], *part)
    if splits > 1:
        ext.pairwise_topk_merge(*part, row_mask, n, od, oi, oc)
    count_launch("pairwise_topk", wide=k > 32)
    return out
