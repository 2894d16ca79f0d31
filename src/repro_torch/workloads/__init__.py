"""Graph workloads on a resident index (port of ``repro.workloads``).

Batch analytics whose hot loop IS neighbor search: kNN-graph
construction (:func:`build_knn_graph`) and DBSCAN density clustering
(:func:`dbscan`), both driven through the planner's ``AllPairsSpec``
self-query route so every backend — brute, fixed_radius, trueknn, and
sharded with its shards on the host or placed on mesh positions —
serves them with identical, deterministic answers.  Host-side numpy over
``index.query(None, AllPairsSpec(...))``; the search runs on the index's
device.
"""

from .cluster import DbscanResult, dbscan
from .graph import (
    KnnGraph,
    build_knn_graph,
    ids_to_rows,
    snapshot_ids,
    symmetrize_edges,
)
from .unionfind import connected_components, uf_build, uf_find, uf_roots, uf_union

__all__ = [
    "DbscanResult",
    "KnnGraph",
    "build_knn_graph",
    "connected_components",
    "dbscan",
    "ids_to_rows",
    "snapshot_ids",
    "symmetrize_edges",
    "uf_build",
    "uf_find",
    "uf_roots",
    "uf_union",
]
