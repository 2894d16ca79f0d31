"""Index state carried in from numpy arrays.

The port has no weights; its state is the index: the hash grids and
TrueKNN's radius lattice and warm-start values.  These functions build
that state from plain numpy arrays and floats — whatever produced them
(another process, a saved index, the JAX reference package) — so two
implementations can be fed the same grid and the same warm state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.grid import Grid

__all__ = ["grid_from_numpy", "trueknn_state_from_numpy", "TrueKNNState"]


def grid_from_numpy(buckets, point_cells, origin, inv_cell, res, table_size,
                    cap, n_points, cell_size, device="cuda") -> Grid:
    """A port ``Grid`` on ``device`` from its arrays: ``buckets`` (H, cap)
    int32, ``point_cells`` (N+1, d) int32, ``origin`` / ``inv_cell`` (d,)
    float32, ``res`` (d,) ints, ``cell_size`` (d,) float32."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    res_t = tuple(int(r) for r in np.asarray(res).ravel())
    buckets = t(buckets, torch.int32)
    if tuple(buckets.shape) != (int(table_size), int(cap)):
        raise ValueError(
            f"buckets {tuple(buckets.shape)} != (table_size, cap) "
            f"({table_size}, {cap})"
        )
    return Grid(
        buckets=buckets.contiguous(),
        point_cells=t(point_cells, torch.int32).contiguous(),
        origin=t(origin, torch.float32),
        inv_cell=t(inv_cell, torch.float32),
        res=res_t,
        res_arr=torch.tensor(res_t, dtype=torch.int32, device=dev),
        table_size=int(table_size),
        cap=int(cap),
        n_points=int(n_points),
        cell_size=np.asarray(cell_size, np.float32),
    )


@dataclasses.dataclass(frozen=True)
class TrueKNNState:
    """TrueKNN's radius lattice (``anchor``, ``j_cap``) and warm-start
    values (``warm_r``: the resolved-radius EMA, ``sampled_r``: the Alg. 2
    start radius).  ``apply(index)`` seeds a port ``TrueKNNIndex``."""

    anchor: Optional[float]
    j_cap: Optional[int]
    warm_r: Optional[float]
    sampled_r: Optional[float]

    def apply(self, index) -> None:
        index._anchor = self.anchor
        index._j_cap = self.j_cap
        index._warm_r = self.warm_r
        index._sampled_r = self.sampled_r


def trueknn_state_from_numpy(anchor, j_cap, warm_r, sampled_r) -> TrueKNNState:
    """The lattice / warm-start state as plain Python numbers (None where
    the source had none yet)."""

    def f(x):
        return None if x is None else float(x)

    return TrueKNNState(
        anchor=f(anchor),
        j_cap=None if j_cap is None else int(j_cap),
        warm_r=f(warm_r),
        sampled_r=f(sampled_r),
    )
