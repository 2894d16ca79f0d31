"""Engines of the port: grid binning, fixed-radius rounds, the fused round
loop, the exact brute engine, the Alg. 2 sampler, the spatial partitioner
and the mesh-sharded engines (torch; the kernels
they launch live in ``repro_torch.kernels`` and ``csrc/``).  The public
search surface is ``repro_torch.api``."""

from .datasets import DATASETS, make_dataset
from .distributed import DeviceMesh
from .partition import (
    Partition,
    aabb_max_dists,
    aabb_min_dists,
    morton_codes,
    partition_points,
)
from .result import KNNResult, RangeResult, RoundStats

__all__ = ["DATASETS", "make_dataset", "DeviceMesh", "Partition",
           "partition_points", "morton_codes", "aabb_min_dists",
           "aabb_max_dists", "KNNResult", "RangeResult", "RoundStats"]
