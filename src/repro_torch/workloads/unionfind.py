"""Array-based union-find with deterministic min-label roots (port of
``repro.workloads.unionfind``).

The clustering driver (``repro_torch.workloads.cluster``) folds core-core
edges through this structure; determinism of the final labels — across
backends, across edge orderings, across duplicated edges — rests on two
choices here:

* **Union by min root.**  ``uf_union`` always attaches the larger root
  under the smaller, so every component's root is its minimum member id
  — a property of the *set* of edges, independent of the order they were
  folded in.  (Classic union-by-rank roots depend on edge order.)
* **Path halving.**  ``uf_find`` halves paths as it walks; halving only
  re-points nodes at ancestors, never changes any root, so it composes
  with the invariant above.

Consequently the fold is idempotent (duplicate edges are no-ops) and
commutative (any permutation of the edge list yields the same parent
roots) — the property tests in ``tests/test_torch_workloads.py`` assert
both.
"""

from __future__ import annotations

import numpy as np

__all__ = ["uf_build", "uf_find", "uf_union", "uf_roots",
           "connected_components"]


def uf_build(n: int) -> np.ndarray:
    """Parent array of ``n`` singleton sets (each node its own root)."""
    return np.arange(int(n), dtype=np.int64)


def uf_find(parent: np.ndarray, i: int) -> int:
    """Root of ``i``'s set, halving the path walked (grandparent
    re-pointing — amortized near-constant, and root-preserving)."""
    i = int(i)
    while parent[i] != i:
        parent[i] = parent[parent[i]]
        i = int(parent[i])
    return i


def uf_union(parent: np.ndarray, a: int, b: int) -> int:
    """Merge the sets of ``a`` and ``b``; the surviving root is the
    SMALLER of the two roots (min-label invariant).  Returns it."""
    ra = uf_find(parent, a)
    rb = uf_find(parent, b)
    if ra == rb:
        return ra
    if rb < ra:
        ra, rb = rb, ra
    parent[rb] = ra
    return ra


def uf_roots(parent: np.ndarray) -> np.ndarray:
    """(n,) root of every node — full compression, vectorized: repeatedly
    jump pointers until the parent array is a fixed point."""
    parent = parent.copy()
    while True:
        gp = parent[parent]
        if np.array_equal(gp, parent):
            return parent
        parent = gp


def connected_components(n: int, edges) -> np.ndarray:
    """(n,) component root per node — the minimum member id of each
    component, whatever the order or multiplicity of ``edges`` (an
    (E, 2) array-like of node-id pairs)."""
    parent = uf_build(n)
    for a, b in np.asarray(edges, np.int64).reshape(-1, 2):
        uf_union(parent, a, b)
    return uf_roots(parent)
