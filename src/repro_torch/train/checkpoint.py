"""Atomic checkpointing (port of ``repro.train.checkpoint``).

Layout per step:  <dir>/step_<N>/
    manifest.json   step, format, leaf count, meta, each leaf's dtype
    arrays.npz      the state's leaves, copied to the host

Guarantees:
  * atomic publish — written to ``step_<N>.tmp`` then os.rename'd, so a
    preemption mid-write never corrupts the latest checkpoint;
  * re-placement on restore — leaves are loaded on the host and moved to
    the device of the matching tensor of ``like`` (or to ``device=``), so
    a run saved on the card restores on the CPU and back;
  * bounded retention — keep_last prunes old steps after a successful
    publish;
  * bitwise leaves — numpy has no bfloat16, so a bf16 leaf is stored as
    its int16 bits and the manifest records its dtype.

The state is a dict whose values are tensors, dicts of the same, or an
``nn.Module`` (its ``named_parameters()``); leaf keys join the dict keys
and parameter names with ``§``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

_SEP = "§"


def _leaves(tree, prefix=()):
    """(key, tensor) pairs of ``tree`` in order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save_checkpoint(directory, step: int, state: dict, *, meta=None, keep_last=3):
    """Publish ``state`` as step ``step``.  Returns the published path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = dict(_leaves(state))
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: _to_numpy(t) for k, t in leaves.items()})
    manifest = {
        "step": step,
        "format": 1,
        "n_leaves": len(leaves),
        "meta": meta or {},
        "dtypes": {k: str(t.dtype).removeprefix("torch.")
                   for k, t in leaves.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(directory, keep_last)
    return final


def _prune(directory, keep_last: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _restore(tree, prefix, load, device):
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                p.data = load(_SEP.join(prefix + (name,)), p, device)
        return tree
    if isinstance(tree, dict):
        return {k: _restore(v, prefix + (str(k),), load, device)
                for k, v in tree.items()}
    return load(_SEP.join(prefix), tree, device)


def restore_checkpoint(directory, step: int, like: dict, *, device=None,
                       shardings=None):
    """Restore into the structure of ``like`` (the same layout of tensors,
    dicts and modules).  Each leaf takes the dtype of ``like``'s and lands
    on ``device``, or on the device of ``like``'s tensor when None.  An
    ``nn.Module`` in ``like`` is loaded in place and returned.  Returns
    (state, manifest).

    ``shardings`` (``{key: tree of NamedSharding}`` for some of ``like``'s
    top-level keys) re-places those entries onto the current mesh: each
    becomes ``parallel.shard_tree``'s ``{position: slices}``, whatever
    mesh the checkpoint was saved from (the elastic restore).  Their
    leaves are loaded on the CPU first (``like`` may hold meta tensors
    there)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = [k for k, _ in _leaves(like) if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} leaves, e.g. "
                           f"{missing[:3]}")

        def load(key, proto, dev):
            t = torch.from_numpy(data[key])
            if manifest["dtypes"][key] == "bfloat16":
                t = t.view(torch.bfloat16)
            want = tuple(proto.shape)
            if tuple(t.shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {want}")
            return t.to(device=proto.device if dev is None else dev,
                        dtype=proto.dtype)

        shardings = shardings or {}
        state = {k: _restore(v, (str(k),), load,
                             torch.device("cpu") if k in shardings else device)
                 for k, v in like.items()}
    if shardings:
        from ..parallel.sharding import shard_tree

        state.update({k: shard_tree(state[k], sh)
                      for k, sh in shardings.items()})
    return state, manifest
