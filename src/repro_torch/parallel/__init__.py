"""Parallelism of the port (port of ``repro.parallel``): sharding rules,
the pipeline and compressed collectives over a ``DeviceMesh``."""

from .collectives import compressed_psum_mean, tree_compressed_psum_mean
from .pipeline import pipeline_apply
from .sharding import (
    NamedSharding,
    PartitionSpec,
    batch_shardings,
    cache_shardings,
    fsdp_axes,
    gather_tree,
    param_shardings,
    replicated,
    shard_tree,
)

__all__ = [
    "compressed_psum_mean",
    "tree_compressed_psum_mean",
    "pipeline_apply",
    "batch_shardings",
    "cache_shardings",
    "fsdp_axes",
    "param_shardings",
    "replicated",
    "NamedSharding",
    "PartitionSpec",
    "shard_tree",
    "gather_tree",
]
