"""State carried in from numpy arrays.

The port's state is the index — the hash grids and TrueKNN's radius
lattice and warm-start values, and a kNN-LM datastore's projected keys,
targets and PCA projection — and an LM's weights and optimizer state.
These functions build that state from plain numpy arrays and floats,
whatever produced them (another process, a saved index, the JAX reference
package), so two implementations can be fed the same grid, warm state,
datastore, weights or optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.grid import Grid

__all__ = ["grid_from_numpy", "trueknn_state_from_numpy", "TrueKNNState",
           "datastore_from_reference", "lm_named_leaves",
           "lm_params_from_reference", "adamw_state_from_reference",
           "shardings_from_reference"]


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


def datastore_from_reference(keys3d, targets, mean, components, *,
                             backend: str = "trueknn", device="cuda", **cfg):
    """A port ``knnlm.Datastore`` from a datastore's numpy state: the
    projected keys (N, 3), the targets (N,), and the PCA projection's
    ``mean`` (D,) and ``components`` (D, 3).  The keys are taken as they
    are (no refit), and the index over them is built on ``device`` with
    ``backend`` and ``cfg``."""
    from .api import build_index
    from .core.knnlm import Datastore, PCAProjector

    keys3d = np.ascontiguousarray(keys3d, np.float32)
    return Datastore(
        keys3d=keys3d,
        targets=np.asarray(targets, np.int32),
        projector=PCAProjector(mean=np.asarray(mean, np.float32),
                               components=np.asarray(components, np.float32)),
        index=build_index(keys3d, backend=backend, device=device, **cfg),
    )


def _tensor(arr) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (numpy's ``ml_dtypes``
    extension type) come across through their bits."""
    arr = np.array(arr, order="C")  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_named_leaves(tree, cfg) -> dict:
    """The leaves of a reference LM pytree as ``{name: np.ndarray}``, keyed
    by the port's ``LM.named_parameters()`` names.

    ``tree`` has the reference's parameter layout: ``embed``,
    ``final_norm``, ``unembed`` (unless tied) and ``layers`` =
    ``{"prefix": [..], "body": [..], "suffix": [..]}``, whose body entry j
    stacks the leaves of layers ``stack_plan(cfg)[1][j]`` along a leading
    axis.  The body is unstacked into one entry per layer.  Any tree of
    that layout maps: the weights, ``jax.grad``'s gradients, AdamW's
    moments.
    """
    return {k: np.asarray(v)
            for k, v in _named_layers(tree, cfg, lambda a, i: a[i]).items()}


def shardings_from_reference(tree, cfg) -> dict:
    """The ``PartitionSpec`` of every leaf of a reference tree of
    ``NamedSharding``s as ``{name: parallel.PartitionSpec}``, keyed by the
    port's names: the parameter layout (``lm_named_leaves``'s; names as
    ``LM.named_parameters()``), or the decode caches' ``{"prefix",
    "body", "suffix"}`` layout (names ``layers.<i>.<key>``, as
    ``parallel.cache_shardings``' list flattens).  A body leaf's spec
    loses its leading entry, the stacked layer dim's ``None``."""
    from .parallel.sharding import PartitionSpec

    if "layers" not in tree:
        tree = {"layers": tree}
    flat = _named_layers(tree, cfg,
                         lambda sh, i: PartitionSpec(*tuple(sh.spec)[1:]))
    return {k: v if isinstance(v, PartitionSpec) else PartitionSpec(*v.spec)
            for k, v in flat.items()}


def _named_layers(tree, cfg, take) -> dict:
    """``{port name: leaf}`` of a reference tree of the parameter layout;
    ``take(leaf, period)`` picks one layer's leaf from a stacked body
    leaf."""
    from .models.transformer import stack_plan

    pre, scanned, suffix = stack_plan(cfg)
    layers = tree["layers"]
    per_layer = {i: layers["prefix"][n] for n, i in enumerate(pre)}
    for j, ids in enumerate(scanned):
        for period, i in enumerate(ids):
            per_layer[i] = _index_tree(layers["body"][j], period, take)
    per_layer.update({i: layers["suffix"][n] for n, i in enumerate(suffix)})

    flat = {}
    for key in ("embed", "final_norm", "unembed"):
        if key in tree:
            flat[key] = tree[key]
    for i in sorted(per_layer):
        _flatten(per_layer[i], f"layers.{i}", flat)
    return flat


def lm_params_from_reference(tree, cfg, device="cuda"):
    """A port ``models.LM`` on ``device`` holding the reference's weights
    (``tree``: the reference's parameter pytree with numpy leaves, mapped
    by ``lm_named_leaves``).  Each layer's leaves land in the parameters
    of the same names."""
    from .models.model import LM

    dev = resolve_device(device)
    model = LM(cfg, "meta")
    flat = lm_named_leaves(tree, cfg)
    want = {name for name, _ in model.named_parameters()}
    if set(flat) != want:
        raise ValueError(f"reference leaves {sorted(set(flat) ^ want)} do "
                         "not match the port's parameters")
    state = {name: _tensor(arr) for name, arr in flat.items()}
    model.to_empty(device=dev)
    with torch.no_grad():
        for name, param in model.named_parameters():
            src = state[name]
            if (tuple(src.shape), src.dtype) != (tuple(param.shape),
                                                 param.dtype):
                raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} "
                                 f"!= {tuple(param.shape)} {param.dtype}")
            param.copy_(src)
    return model


def adamw_state_from_reference(opt_state, cfg, device="cuda") -> dict:
    """The port's AdamW state (``optim.adamw_init``'s layout) on ``device``
    from the reference's ``{"mu": tree, "nu": tree, "count": int32}``: the
    moment trees mapped by ``lm_named_leaves``, ``count`` an int32
    scalar tensor."""
    dev = resolve_device(device)

    def moments(tree):
        return {name: _tensor(arr).to(dev)
                for name, arr in lm_named_leaves(tree, cfg).items()}

    return {
        "mu": moments(opt_state["mu"]),
        "nu": moments(opt_state["nu"]),
        "count": torch.tensor(int(np.asarray(opt_state["count"])),
                              dtype=torch.int32, device=dev),
    }


def _index_tree(tree, i, take):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i, take) for k, v in tree.items()}
    return take(tree, i)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}.{k}", out)
        else:
            out[f"{prefix}.{k}"] = v
