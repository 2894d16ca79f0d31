"""Built-in ``NeighborIndex`` backends of the port.

Importing this package registers:

  brute         exact dense distances (the oracle; every metric, range on
                the ``pairwise_topk`` kernel's counter)
  fixed_radius  one grid round within an exact radius ball (paper Alg. 1)
  trueknn       multi-round unbounded search with grid cache + warm start
                (paper Alg. 3; the serving default)

The reference's ``sharded``, ``distributed`` and ``mutable`` backends are
not ported yet.
"""

from .brute import BruteIndex
from .fixed_radius import FixedRadiusIndex
from .trueknn import TrueKNNIndex

__all__ = ["BruteIndex", "FixedRadiusIndex", "TrueKNNIndex"]
