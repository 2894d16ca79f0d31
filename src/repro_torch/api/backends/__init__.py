"""Built-in ``NeighborIndex`` backends of the port.

Importing this package registers:

  brute         exact dense distances (the oracle; every metric, range on
                the ``pairwise_topk`` kernel's counter)
  fixed_radius  one grid round within an exact radius ball (paper Alg. 1)
  trueknn       multi-round unbounded search with grid cache + warm start
                (paper Alg. 3; the serving default)
  distributed   points sharded over a ``DeviceMesh``, hypercube top-k merge
  sharded       spatially-partitioned composite over child indexes, with
                radius-aware shard pruning (``placement="host"``, or
                ``"devices"``: the shards placed on a 1-D ``DeviceMesh``)
  mutable       LSM composite over any immutable base: insert/delete on a
                resident index, brute delta shards, tombstones,
                policy-driven compaction (see ``repro_torch.api.mutable``)
"""

from .brute import BruteIndex
from .distributed import DistributedIndex
from .fixed_radius import FixedRadiusIndex
from .mutable import MutableIndex
from .sharded import PRUNE_SLACK, ShardedIndex
from .trueknn import TrueKNNIndex

__all__ = ["BruteIndex", "DistributedIndex", "FixedRadiusIndex",
           "MutableIndex", "ShardedIndex", "PRUNE_SLACK", "TrueKNNIndex"]
