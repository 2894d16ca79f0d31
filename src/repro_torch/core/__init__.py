"""Engines of the port: grid binning, fixed-radius rounds, the fused round
loop, the exact brute engine, the Alg. 2 sampler and the oracle radii, the
spatial partitioner and the mesh-sharded engines (torch; the kernels they
launch live in ``repro_torch.kernels`` and ``csrc/``).  The public search
surface is ``repro_torch.api``; its entry points are re-exported here
lazily, as ``repro.core`` does.  The historical free functions
(``trueknn``, ``fixed_radius_knn``, ``brute_knn``, and the
``TrueKNNResult`` alias) remain, as in the reference, deprecated shims
that build a throwaway index per call (on the card unless ``device="cpu"``)
— correct, but they re-pay structure construction on every invocation,
which is exactly what the index API exists to amortize."""

from .brute import brute_knn, brute_knn_engine
from .datasets import DATASETS, make_dataset
from .distributed import DeviceMesh
from .fixed_radius import fixed_radius_knn, fixed_radius_round
from .grid import Grid, build_grid
from .partition import (
    Partition,
    aabb_max_dists,
    aabb_min_dists,
    morton_codes,
    partition_points,
)
from .result import (
    KNNResult,
    RangeResult,
    RoundStats,
    merge_knn,
    merge_range,
    topk_merge_rows,
)
from .sampling import (
    max_knn_distance,
    percentile_knn_distance,
    sample_start_radius,
)
from .trueknn import TrueKNNResult, trueknn

__all__ = [
    "brute_knn",
    "brute_knn_engine",
    "DATASETS",
    "make_dataset",
    "DeviceMesh",
    "fixed_radius_knn",
    "fixed_radius_round",
    "Grid",
    "build_grid",
    "Partition",
    "partition_points",
    "morton_codes",
    "aabb_min_dists",
    "aabb_max_dists",
    "KNNResult",
    "RangeResult",
    "RoundStats",
    "merge_knn",
    "merge_range",
    "topk_merge_rows",
    "max_knn_distance",
    "percentile_knn_distance",
    "sample_start_radius",
    "TrueKNNResult",
    "trueknn",
    # lazily re-exported from repro_torch.api via __getattr__:
    "build_index",
    "NeighborIndex",
    "register_backend",
    "available_backends",
]

_API_NAMES = ("build_index", "NeighborIndex", "register_backend",
              "available_backends")


def __getattr__(name):
    # late-bound so importing repro_torch.core never drags in the backend
    # modules (which import core submodules) during package initialization
    if name in _API_NAMES:
        from .. import api

        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
