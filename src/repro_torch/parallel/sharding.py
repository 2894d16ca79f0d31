"""Sharding rules (port of ``repro.parallel.sharding``): FSDP x TP x EP
partition specs for every tensor of the system, divisibility-aware (a dim
is only sharded when the mesh axes divide it; otherwise it degrades to
replication on that dim, never to an error).

Axis roles:
  * ``model``      — tensor parallel: attention heads / FFN width / vocab /
                     experts / (decode) KV-cache sequence.
  * ``data``(+``pod``) — batch parallel AND FSDP: every weight's
                     d_model-ish dim is sharded here.

The rules are structural, keyed on the last component of a tensor's name,
so any layer that follows the naming conventions shards without new code.
The reference stacks the scanned layers' parameters and caches along a
leading dim and strips it before applying a rule; the port's layers are
not stacked (``layers.<i>.…``), so each tensor takes the rule directly.

Placement is the port's own: a ``NamedSharding`` on a ``DeviceMesh`` says
which slice of a tensor each mesh position holds (``index``), and
``shard`` / ``gather`` move a tensor to those slices and back, the
counterparts of ``jax.device_put`` and of reading a sharded array whole.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.distributed import DeviceMesh
from ..models.common import ModelConfig

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "fsdp_axes",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "replicated",
    "shard_tree",
    "gather_tree",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (sharded over their product, the first outermost).
    A one-name tuple is stored as the name, as ``jax.sharding``'s does."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axsize(mesh: DeviceMesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _axes(axes))


class NamedSharding:
    """A ``PartitionSpec`` on a ``DeviceMesh``: which slice of a tensor
    every mesh position holds.  Positions are the mesh's index tuples.
    The rule functions below also record the ``shape`` and ``dtype`` of
    the tensor each sharding was made for (None otherwise), from which
    ``launch.analysis`` sizes collectives and per-position bytes."""

    def __init__(self, mesh: DeviceMesh, spec, *, shape=None, dtype=None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        self.shape = None if shape is None else tuple(shape)
        self.dtype = dtype
        for e in self.spec:
            for a in _axes(e):
                if a not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not on mesh {mesh.axis_names}")

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def _entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def local_shape(self, shape) -> tuple:
        """The shape every position holds; raises ``ValueError`` when an
        entry's axes do not divide its dim (the counterpart of XLA's
        sharding mismatch)."""
        out = []
        for dim, e in zip(shape, self._entries(len(shape))):
            n = _axsize(self.mesh, e)
            if dim % n:
                raise ValueError(f"dim {dim} of shape {tuple(shape)} does not "
                                 f"split over {_axes(e)} ({n} shards) in "
                                 f"spec {self.spec}")
            out.append(dim // n)
        return tuple(out)

    def positions(self):
        """The mesh's positions in row-major order."""
        return list(np.ndindex(self.mesh.devices.shape))

    @property
    def n_slices(self) -> int:
        """How many distinct slices the positions hold (1: replicated)."""
        return math.prod(_axsize(self.mesh, e) for e in self.spec)

    def shard_id(self, pos: tuple, entry) -> int:
        """Which of its entry's shards position ``pos`` holds (row-major
        over the entry's axes)."""
        i = 0
        for a in _axes(entry):
            i = i * self.mesh.shape[a] + pos[self.mesh.axis_names.index(a)]
        return i

    def index(self, pos: tuple, shape) -> tuple:
        """The slices of a tensor of ``shape`` that position ``pos``
        holds."""
        local = self.local_shape(shape)
        return tuple(slice(self.shard_id(pos, e) * n,
                           (self.shard_id(pos, e) + 1) * n)
                     for n, e in zip(local, self._entries(len(shape))))

    def shard(self, tensor: torch.Tensor) -> dict:
        """``{position: tensor's slice}``, each a contiguous copy of its
        own on the position's device (positions that hold the same slice
        never share storage, so each may update its copy in place)."""
        out = {}
        for pos in self.positions():
            part = tensor[self.index(pos, tensor.shape)]
            dst = torch.empty(part.shape, dtype=tensor.dtype,
                              device=self.mesh.devices[pos])
            out[pos] = dst.copy_(part)
        return out

    def gather(self, shards: dict, device=None, *, log=None) -> torch.Tensor:
        """The whole tensor from ``shards`` (``shard``'s layout), on
        ``device`` (the mesh's first device by default).  A slice held by
        several positions is read from the first of them.  ``log``, a
        collective log, gains ("all-gather", the whole tensor's bytes)
        when the tensor was put together from more than one slice."""
        first = shards[next(iter(shards))]
        local = tuple(first.shape)
        entries = self._entries(len(local))
        shape = tuple(n * _axsize(self.mesh, e)
                      for n, e in zip(local, entries))
        dev = self.mesh.first_device if device is None else device
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        seen = set()
        for pos in self.positions():
            idx = self.index(pos, shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = shards[pos].to(dev)
        if log is not None and len(seen) > 1:
            log.append(("all-gather", out.numel() * out.element_size()))
        return out


def fsdp_axes(mesh: DeviceMesh) -> tuple:
    """Compound batch/FSDP axis: ('pod','data') when pod exists."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _maybe(mesh: DeviceMesh, dim: int, axes):
    """axes if they divide dim else None."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


def _param_spec(name: str, shape, cfg: ModelConfig,
                mesh: DeviceMesh) -> PartitionSpec:
    f = fsdp_axes(mesh)
    m = "model"
    d = shape

    def spec(*entries):
        return P(*(_maybe(mesh, dim, ax) for dim, ax in zip(d, entries)))

    ndim = len(shape)

    if name == "embed":  # (V, D)
        return spec(m, f)
    if name == "unembed":  # (D, V)
        return spec(f, m)
    if name in ("wq", "wk", "wv"):  # (D, H*dh) — shard heads when whole
        heads = cfg.n_heads if name == "wq" else cfg.n_kv_heads
        ax1 = m if heads % _axsize(mesh, m) == 0 else None
        return P(_maybe(mesh, d[0], f), _maybe(mesh, d[1], ax1) if ax1 else None)
    if name == "wo":  # (H*dv, D)
        ax0 = m if cfg.n_heads % _axsize(mesh, m) == 0 else None
        return P(_maybe(mesh, d[0], ax0) if ax0 else None, _maybe(mesh, d[1], f))
    if name in ("w_gate", "w_up"):
        if ndim == 3:  # MoE expert bank (E, D, F): EP on experts
            return spec(m, f, None)
        return spec(f, m)  # dense (D, F)
    if name == "w_down":
        if ndim == 3:  # (E, F, D)
            return spec(m, None, f)
        return spec(m, f)  # dense (F, D)
    if name == "router":  # (D, E)
        return spec(f, m)
    # MLA pieces
    if name == "w_dkv":  # (D, r+dr) — latent is small; FSDP only
        return spec(f, None)
    if name in ("w_uk", "w_uv"):  # (r, H*dh)
        return spec(None, m)
    # SSM / RG-LRU mixing
    if name == "w_in":  # (D, F_mixed) — segment boundaries misalign with TP
        return spec(f, None)
    if name in ("w_x",):  # (D, dr)
        return spec(f, m)
    if name in ("w_r", "w_i"):  # (dr, dr)
        return spec(f, m)
    if name == "w_out":  # (dr|d_inner, D)
        return spec(m, f)
    if name in ("conv_w", "conv_b"):
        return P(*([None] * ndim))
    if ndim >= 2:
        return spec(f, *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def _named_leaves(tree, prefix=""):
    """(key, tensor) pairs of a tensor, an ``nn.Module`` (its
    ``named_parameters()``), or nested dicts / lists of those; keys join
    with ``.`` as parameter names do."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_tree(tree, fn, prefix=""):
    """``tree``'s structure (an ``nn.Module`` becomes the dict of its
    parameters) with ``fn(key, leaf)`` at every leaf."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_shardings(named, cfg: ModelConfig, mesh: DeviceMesh, *,
                    role="params"):
    """``NamedSharding`` of every tensor of ``named``: an ``LM`` (its
    parameters by name), its gradients, or AdamW's state (``{"mu": {..},
    "nu": {..}, "count"}``), in the same structure (a module becomes the
    dict of its parameters).  The rule keys on the last component of
    each parameter name.

    ``role``: under cfg.zero1, "params" drop their data-axis (FSDP) shards
    (TP-only, data-replicated for compute) while "opt" (optimizer moments)
    keep full FSDPxTP sharding (ZeRO-1)."""
    strip_fsdp = getattr(cfg, "zero1", False) and role == "params"
    fs = set(fsdp_axes(mesh))

    def _strip(spec: PartitionSpec) -> PartitionSpec:
        if not strip_fsdp:
            return spec
        out = []
        for e in spec:
            axes = _axes(e)
            if any(a in fs for a in axes):
                kept = tuple(a for a in axes if a not in fs)
                out.append(kept[0] if len(kept) == 1 else (kept or None))
            else:
                out.append(e)
        return P(*out)

    def leaf(key, x):
        name = key.split(".")[-1]
        return NamedSharding(
            mesh, _strip(_param_spec(name, tuple(x.shape), cfg, mesh)),
            shape=x.shape, dtype=x.dtype)

    return _map_tree(named, leaf)


def batch_shardings(batch, cfg: ModelConfig, mesh: DeviceMesh):
    """tokens/labels (B, S): batch over fsdp axes (+model for attn-free
    archs, where pure DP beats TP); prefix_embeds (B, P, D) likewise."""
    f = list(fsdp_axes(mesh))
    if cfg.attn_type == "none" or getattr(cfg, "pure_dp", False):
        f = f + ["model"]  # all-DP: params are small/replicable, batch is not

    def leaf(key, x):
        b = x.shape[0]
        ax = tuple(f)
        while ax and b % _axsize(mesh, ax) != 0:
            ax = ax[:-1]  # drop trailing axes until divisible
        ax = ax if ax else None
        rest = [None] * (len(x.shape) - 1)
        return NamedSharding(mesh, P(ax, *rest), shape=x.shape, dtype=x.dtype)

    return _map_tree(batch, leaf)


def cache_shardings(caches, cfg: ModelConfig, mesh: DeviceMesh):
    """Decode caches: a list of per-layer cache dicts (``k``, ``v``,
    ``pos`` | MLA ``c``, ``kr`` | SSM ``state``, ``conv`` | RG-LRU ``h``,
    ``conv``).  Batch -> fsdp axes; then TP: kv-heads if divisible, else
    the cache sequence dim (sequence-parallel KV)."""
    f = fsdp_axes(mesh)
    msize = _axsize(mesh, "model")

    def batch(b):
        return f if b % _axsize(mesh, f) == 0 else None

    def leaf(key, x):
        name = key.split(".")[-1]
        core = tuple(x.shape)
        spec: list = [None] * len(core)
        if name in ("k", "v") and len(core) == 4:
            b, s, kv, dh = core
            spec[0] = batch(b)
            if kv % msize == 0:
                spec[2] = "model"
            elif s % msize == 0:
                spec[1] = "model"
        elif name in ("c", "kr") and len(core) == 3:  # MLA latent (B,S,r)
            b, s, r = core
            spec[0] = batch(b)
            if s % msize == 0:
                spec[1] = "model"
        elif name == "state" and len(core) == 4:  # SSM (B,H,P,N)
            b, h, p_, n = core
            spec[0] = batch(b)
            if h % msize == 0:
                spec[1] = "model"
        elif name == "h" and len(core) == 2:  # RG-LRU (B, dr)
            b, dr = core
            spec[0] = batch(b)
            if dr % msize == 0:
                spec[1] = "model"
        elif name == "conv" and len(core) == 3:  # (B, K-1, C)
            spec[0] = batch(core[0])
        elif name == "pos":
            pass  # tiny; replicate
        elif core:
            spec[0] = batch(core[0])
        return NamedSharding(mesh, P(*spec), shape=x.shape, dtype=x.dtype)

    return _map_tree(caches, leaf)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_tree(tree, shardings) -> dict:
    """``{position: tree of that position's slices}``: every tensor of
    ``tree`` placed by the ``NamedSharding`` at the same place in
    ``shardings`` (the same structure; a module stands for the dict of
    its parameters)."""
    leaves = dict(_named_leaves(tree))
    shs = dict(_named_leaves(shardings))
    parts = {key: shs[key].shard(t) for key, t in leaves.items()}
    positions = next(iter(shs.values())).positions()
    return {pos: _map_tree(tree, lambda key, _: parts[key][pos])
            for pos in positions}


def gather_tree(shards: dict, shardings, device=None):
    """The whole tree from ``shard_tree``'s layout, on ``device`` (the
    mesh's first device by default)."""
    per_pos = {pos: dict(_named_leaves(t)) for pos, t in shards.items()}
    first = next(iter(shards.values()))
    shs = dict(_named_leaves(shardings))
    return _map_tree(first, lambda key, _: shs[key].gather(
        {pos: leaves[key] for pos, leaves in per_pos.items()}, device))
