"""PyTorch/CUDA port of the TrueKNN reproduction (the JAX package ``repro``
is the reference and stays as it is).

    from repro_torch import build_index, KnnSpec, make_dataset

    pts = make_dataset("kitti", 1 << 20)
    index = build_index(pts, backend="trueknn")          # device="cuda"
    res = index.query(None, KnnSpec(8))                  # self-query

Backends ``brute``, ``fixed_radius``, ``trueknn``, ``distributed``
(points sharded over a ``DeviceMesh``), ``sharded`` (a spatially
partitioned composite; ``placement="devices"`` pins its shards to a 1-D
``DeviceMesh``) and ``mutable`` (inserts and deletes over any of them)
answer every spec and metric through the planner;
``repro_torch.workloads`` builds kNN graphs and DBSCAN clusterings on
top.  Indexes live on the card by default
and run the hand-written CUDA kernels (``csrc/``); ``device="cpu"`` runs
their plain PyTorch versions.  This package imports torch, numpy and the
standard library only.
"""

from .api import (
    AllPairsSpec,
    CompactionPolicy,
    DeviceMesh,
    HybridSpec,
    KnnSpec,
    NeighborIndex,
    QuerySpec,
    RangeSpec,
    available_backends,
    build_index,
    make_mutable,
    map_to_stable,
)
from .core.datasets import make_dataset
from .core.result import KNNResult, RangeResult, RoundStats

__all__ = [
    "build_index",
    "available_backends",
    "make_mutable",
    "map_to_stable",
    "CompactionPolicy",
    "DeviceMesh",
    "NeighborIndex",
    "QuerySpec",
    "KnnSpec",
    "RangeSpec",
    "HybridSpec",
    "AllPairsSpec",
    "make_dataset",
    "KNNResult",
    "RangeResult",
    "RoundStats",
]
