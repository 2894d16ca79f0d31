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
top, ``NeighborServer`` serves any of them behind a microbatching
request queue, ``repro_torch.core.knnlm`` is a kNN-LM datastore on a
resident index, ``repro_torch.models`` / ``configs`` / ``serve`` are the
LM stack (ten architectures' decoders and ``BatchedServer``), and
``python -m repro_torch.launch.serve`` is the serving launcher (LM and
neighbor search); ``repro_torch.examples`` holds runnable examples.
Indexes and models live on the card by default; indexes run the
hand-written CUDA kernels (``csrc/``), and ``device="cpu"`` runs their
plain PyTorch versions.  This package imports torch, numpy and the
standard library only.
"""

from .api import (
    AdmissionError,
    AllPairsSpec,
    CompactionPolicy,
    DeviceMesh,
    HybridSpec,
    KnnSpec,
    NeighborIndex,
    NeighborServer,
    QuerySpec,
    RangeSpec,
    Ticket,
    available_backends,
    build_index,
    dropped_counts,
    make_mutable,
    map_to_stable,
    warm_default_radius,
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
    "NeighborServer",
    "Ticket",
    "AdmissionError",
    "warm_default_radius",
    "dropped_counts",
]
