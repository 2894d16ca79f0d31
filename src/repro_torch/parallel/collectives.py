"""Explicit collective helpers (port of ``repro.parallel.collectives``).

``compressed_psum_mean``: int8-quantized data-parallel mean — a shared
scale from one scalar max over the axis, then an integer sum of the
rounded values.  Compose with ``optim.compression``'s error feedback for
unbiased long-run updates.

The reference runs inside ``shard_map``; the port takes the per-position
tensors of a ``DeviceMesh`` (``{position: tensor}``), runs each
position's part on its own device, and moves partner values across with
``.to()``, as ``core.distributed.hypercube_merge`` does.
"""

from __future__ import annotations

import torch

from ..core.distributed import DeviceMesh

__all__ = ["compressed_psum_mean", "tree_compressed_psum_mean"]


def _groups(mesh: DeviceMesh, axis_name: str, positions) -> list:
    """The positions grouped by every coordinate but ``axis_name``'s, each
    group in axis order."""
    dim = mesh.axis_names.index(axis_name)
    groups: dict = {}
    for pos in sorted(positions):
        groups.setdefault(pos[:dim] + pos[dim + 1:], []).append(pos)
    return list(groups.values())


def compressed_psum_mean(xs: dict, mesh: DeviceMesh, axis_name: str, *,
                         log=None) -> dict:
    """Mean of ``xs`` (``{position: tensor}``, every position of ``mesh``)
    over ``axis_name``, with values quantized to int8 for the sum.

    The reference's op order: n, gmax = the max over the axis of each
    position's max |x|, scale = max(gmax, 1e-12) / 127, q = clip(round(x /
    scale), -127, 127) as int8, the int32 sum of the group's q in position
    order, then ``qsum.float() * scale / n``.  Returns ``{position: mean}``
    on each position's device.  ``log``, a list, gets one ("all-reduce",
    bytes) entry for the scalar max and one for the int32 sum, each
    position's result bytes."""
    n = mesh.shape[axis_name]
    out = {}
    for group in _groups(mesh, axis_name, xs):
        if len(group) != n:
            raise ValueError(f"{len(group)} of the {n} positions along "
                             f"{axis_name!r} given")
        local_max = {p: torch.max(torch.abs(xs[p].float())) for p in group}
        q = {}
        scale = {}
        for p in group:
            dev = xs[p].device
            gmax = torch.stack([local_max[o].to(dev) for o in group]).max()
            scale[p] = torch.clamp(gmax, min=1e-12) / 127.0
            q[p] = torch.clamp(torch.round(xs[p].float() / scale[p]),
                               -127, 127).to(torch.int8)
        for p in group:
            dev = xs[p].device
            qsum = q[group[0]].to(dev, torch.int32)
            for o in group[1:]:
                qsum = qsum + q[o].to(dev, torch.int32)
            out[p] = qsum.float() * scale[p] / n
    if log is not None:
        numel = next(iter(xs.values())).numel()
        log.append(("all-reduce", 4))
        log.append(("all-reduce", numel * 4))
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _unflat(items) -> dict:
    out: dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def tree_compressed_psum_mean(trees: dict, mesh: DeviceMesh, axis_name: str,
                              *, log=None) -> dict:
    """``compressed_psum_mean`` of every tensor of per-position trees
    (``{position: {name: tensor}}``, nested dicts allowed)."""
    flat = {pos: dict(_flat(t)) for pos, t in trees.items()}
    paths = list(next(iter(flat.values())))
    means = {path: compressed_psum_mean(
        {pos: leaves[path] for pos, leaves in flat.items()}, mesh, axis_name,
        log=log) for path in paths}
    return {pos: _unflat((path, means[path][pos]) for path in paths)
            for pos in trees}
