"""DBSCAN on a resident index (port of ``repro.workloads.cluster``) —
the RT-DBSCAN decomposition.

RT-DBSCAN (PAPERS.md) showed that density clustering is range search
plus bookkeeping: the eps-neighborhood query IS the hardware-accelerated
part, everything after is cheap set algebra.  ``dbscan(index, eps,
min_pts)`` follows that split exactly:

1. **Core detection** — ONE ``AllPairsSpec(mode="range", radius=eps)``
   self-query (self-excluded CSR; the ``d == eps`` boundary is inclusive,
   the same ``<=`` every range engine uses).  A point is core iff its
   eps-ball holds at least ``min_pts`` points *counting itself* —
   ``counts + 1 >= min_pts``, the classic definition.
2. **Core merging** — array-based union-find (path halving, min-label
   roots — see ``repro_torch.workloads.unionfind``) over core-core edges of
   the eps-graph.  Min-label roots make the component labels a property
   of the edge *set*, so any backend producing the same neighborhoods
   produces bit-identical labels.
3. **Border assignment** — a non-core point with at least one core
   neighbor joins the cluster of its MINIMUM-labeled core neighbor
   (classic DBSCAN is famously order-dependent here; the deterministic
   rule keeps labels reproducible).  Everything else is noise (-1).

Labels are relabeled consecutively ``0..C-1`` ordered by each cluster's
minimum member row, and are ``np.array_equal`` across the brute /
fixed_radius / trueknn / sharded (host or placed) backends and equal to
the JAX package's: each
returns the same exact neighborhoods, and every step after is a
deterministic function of those sets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..api.query import AllPairsSpec

from .graph import ids_to_rows, snapshot_ids
from .unionfind import uf_build, uf_roots, uf_union

__all__ = ["DbscanResult", "dbscan"]


@dataclasses.dataclass
class DbscanResult:
    """Clustering answer.

    labels:   (N,) int64 cluster id per row, ``0..n_clusters-1``; noise
              is -1.  Clusters are numbered by ascending minimum member
              row, so labels are deterministic.
    core:     (N,) bool core-point mask.
    eps / min_pts: the parameters asked.
    generation: index generation the neighborhoods snapshotted.
    """

    labels: np.ndarray
    core: np.ndarray
    n_clusters: int
    eps: float
    min_pts: int
    generation: int
    backend: str = ""
    metric: str = "l2"
    n_tests: int = 0
    #: stable dataset id of each row (mutable backends; None = identity)
    ids: Optional[np.ndarray] = None

    @property
    def n_noise(self) -> int:
        return int((self.labels < 0).sum())


def dbscan(
    index,
    eps: float,
    min_pts: int,
    *,
    metric: str = "l2",
    chunk_rows=None,
    max_retries: int = 8,
) -> DbscanResult:
    """Cluster ``index``'s resident cloud with DBSCAN(eps, min_pts)."""
    eps = float(eps)
    min_pts = int(min_pts)
    if min_pts < 1:
        raise ValueError(f"min_pts must be >= 1, got {min_pts}")
    spec = AllPairsSpec(mode="range", radius=eps, chunk_rows=chunk_rows)
    for _ in range(max(1, int(max_retries))):
        gen = int(getattr(index, "generation", 0) or 0)
        n = index.n_points
        ids = snapshot_ids(index)
        rng = index.query(None, spec, metric=metric)
        if int(getattr(index, "generation", 0) or 0) == gen:
            break
    else:
        raise RuntimeError(
            f"index mutated through {max_retries} consecutive clustering "
            "runs; quiesce writers or raise max_retries"
        )
    counts = rng.counts
    # the eps-neighborhood includes the point itself; the CSR is
    # self-excluded, hence the +1
    core = (counts + 1) >= min_pts
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = ids_to_rows(rng.idxs, ids, int(getattr(index, "sentinel", n)), n)

    # union-find over core-core edges; each undirected edge appears in
    # both directions, and the fold is commutative, so folding just the
    # rows < cols direction gives the same components for half the work
    cc = core[rows] & core[cols] & (rows < cols)
    parent = uf_build(n)
    for a, b in zip(rows[cc], cols[cc]):
        uf_union(parent, a, b)
    roots = uf_roots(parent)

    labels = np.full((n,), -1, np.int64)
    labels[core] = roots[core]  # min core row of each component
    # border points: non-core with >= 1 core neighbor in eps — join the
    # minimum-labeled core neighbor's cluster (deterministic tie rule)
    border_edge = (~core[rows]) & core[cols]
    if border_edge.any():
        br = rows[border_edge]
        bl = roots[cols[border_edge]]
        order = np.lexsort((bl, br))  # per row, smallest label first
        br, bl = br[order], bl[order]
        first = np.ones(br.shape, bool)
        first[1:] = br[1:] != br[:-1]
        labels[br[first]] = bl[first]
    # relabel consecutively, clusters ordered by ascending min member row
    used = np.unique(labels[labels >= 0])
    remap = {int(r): c for c, r in enumerate(used)}
    if remap:
        lut = np.full((int(used.max()) + 1,), -1, np.int64)
        lut[used] = np.arange(len(used))
        pos = labels >= 0
        labels[pos] = lut[labels[pos]]
    return DbscanResult(
        labels=labels,
        core=core,
        n_clusters=len(used),
        eps=eps,
        min_pts=min_pts,
        generation=gen,
        backend=index.backend_name,
        metric=rng.metric,
        n_tests=int(rng.n_tests),
        ids=ids,
    )
