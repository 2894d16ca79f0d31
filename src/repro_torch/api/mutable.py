"""Mutation surface of the API (port of ``repro.api.mutable``):
compaction policy, index adoption, and the stable-id mapping used to
check mutable answers against rebuilds.

The backend itself lives in ``repro_torch.api.backends.mutable`` (registered as
``backend="mutable"``); this module owns the pieces that are not an
engine:

* :class:`CompactionPolicy` — when the LSM composite folds its delta
  shards and tombstones back into the base.
* :func:`make_mutable` — adopt an already-built immutable index as the
  base of a new ``MutableIndex`` (no rebuild; the resident structure and
  its warm state carry over).
* :func:`map_to_stable` — lift a *positional* answer (from a monolithic
  index built over ``snapshot()``'s live rows) into the mutable index's
  stable-id space.  This is the identity oracle of the whole subsystem:
  for any logical snapshot, ``mutable.query(q, spec)`` must equal
  ``map_to_stable(rebuild.query(q, spec), live_ids, mutable.sentinel)``
  bit for bit — ``tests/test_torch_mutable.py`` asserts exactly that
  under seeded insert/delete storms.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .backends.mutable import MutableIndex
from .index import NeighborIndex

__all__ = [
    "CompactionPolicy",
    "MutableIndex",
    "make_mutable",
    "map_to_stable",
]


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When the mutable composite rebuilds its base from the live rows.

    A compaction is *due* when either log outgrows the base:

    * delta rows (sealed + open) reach ``max(min_rows, ratio * base)`` —
      fan-out cost grows with every shard, so the log must fold back
      before reads degrade;
    * tombstones reach ``tombstone_ratio`` of the total resident rows —
      every source over-fetches by the tombstone count, so dead ids tax
      every read until retired.

    ``mode`` says who runs it: ``"inline"`` compacts on the mutating call
    (simple, bounded memory, the writer pays), ``"background"`` rebuilds
    on a daemon thread while reads keep answering from the pre-compaction
    snapshot, ``"off"`` only compacts when ``index.compact()`` is called
    explicitly.
    """

    min_rows: int = 4096
    ratio: float = 0.5
    tombstone_ratio: float = 0.2
    mode: str = "inline"

    def __post_init__(self):
        if self.mode not in ("off", "inline", "background"):
            raise ValueError(
                f"auto_compact must be 'off', 'inline' or 'background', "
                f"got {self.mode!r}"
            )
        if not (self.ratio > 0 and self.tombstone_ratio > 0):
            raise ValueError("compaction ratios must be positive")

    def due(self, base_rows: int, delta_rows: int, tombstones: int) -> bool:
        if delta_rows == 0 and tombstones == 0:
            return False
        if delta_rows >= max(self.min_rows, self.ratio * base_rows):
            return True
        total = base_rows + delta_rows
        return tombstones >= self.tombstone_ratio * max(1, total)


def make_mutable(index, **cfg) -> MutableIndex:
    """Make a writable index.

    * an existing ``NeighborIndex`` is *adopted* as the base of a new
      ``MutableIndex`` — no rebuild, the already-resident structure (and
      its warm-start state) keeps serving as the base, its rows become
      stable ids ``0..N-1``;
    * a ``MutableIndex`` is returned as-is;
    * a raw ``(N, d)`` array builds a fresh one (same as
      ``build_index(points, backend="mutable", **cfg)``).

    ``cfg`` takes the mutable knobs (``delta_rows``, ``auto_compact``,
    ...); when adopting, the base's own build cfg is remembered so
    compactions rebuild it with the same knobs, and the new index lives
    on the base's device.
    """
    if isinstance(index, MutableIndex):
        if cfg:
            raise ValueError(
                "index is already mutable; mutation knobs must be set at "
                "build time"
            )
        return index
    if isinstance(index, NeighborIndex):
        out = MutableIndex(
            np.empty((0, index.dim), np.float32),
            base_backend=index.backend_name,
            base_cfg=dict(getattr(index, "_build_cfg", None) or {}),
            **dict({"device": index.device}, **cfg),
        )
        out._adopt(index)
        return out
    return MutableIndex(np.asarray(index, np.float32), **cfg)


def map_to_stable(res, live_ids, sentinel: int):
    """Map a positional answer over the live snapshot into stable-id
    space (in place on a copy of the idx arrays; everything else is
    shared).

    ``res`` came from a monolithic index built over ``(pts, live_ids) =
    mutable.snapshot()``: its idxs are positions ``0..n_live-1`` with
    ``n_live`` as the padding sentinel.  Position ``i`` is stable id
    ``live_ids[i]`` (ascending, by construction), and the positional
    sentinel maps to the mutable index's ``sentinel``.
    """
    lg = np.empty((np.asarray(live_ids).size + 1,), np.int64)
    lg[:-1] = np.asarray(live_ids, np.int64)
    lg[-1] = int(sentinel)
    lg = lg.astype(np.int32)
    return dataclasses.replace(res, idxs=lg[np.asarray(res.idxs)])
