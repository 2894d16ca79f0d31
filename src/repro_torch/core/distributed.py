"""Distributed kNN (port of ``repro.core.distributed``): points sharded
over a device mesh, hypercube top-k merge.

Layout: points (N, d) split into P equal shards along the mesh's point
axis (``model``); queries (Q, d) split along its batch axes (``pod``,
``data``).  Every mesh position computes the exact streaming top-k of its
query slice against its point shard (``kernels.ops.topk_engine``: the
``pairwise_topk`` kernel on the card, its plain version on the CPU), then
the per-shard candidate lists merge across the point axis in log2(P)
hypercube steps: at step s position i merges its list with that of
position ``i ^ s``.  Top-k merge is associative and commutative, so after
log2(P) steps every position holds the global top-k.

The reference is one controller driving a JAX ``Mesh`` through
``shard_map``; so is the port, in one process.  ``DeviceMesh`` is a grid
of ``torch.device``s with named axes, each position runs its part on its
own device, and partner lists cross devices with ``.to(device)``.  A
device may sit at several positions, so one card (or the CPU) serves a
whole mesh: the counterpart of the reference tests'
``--xla_force_host_platform_device_count``.

The multi-round TrueKNN driver composes on top: query retirement happens
on the host between rounds (compaction), so later rounds move fewer
queries through the mesh.  The reference's ``PlacedFabric`` (the sharded
backend's ``placement="devices"``) is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.ops import as_f32, topk_engine
from .sampling import sample_start_radius

__all__ = [
    "DeviceMesh",
    "batch_axes",
    "place_shards",
    "make_distributed_knn",
    "distributed_trueknn",
    "hypercube_merge",
]

_BATCH_AXES = ("pod", "data")


class DeviceMesh:
    """A grid of devices with named axes (the port's ``jax.sharding.Mesh``).

    ``devices`` is a nested list or array of devices (``torch.device`` or
    strings such as ``"cuda"`` / ``"cpu"``) whose number of dimensions is
    ``len(axis_names)``.  A device may appear at several positions.  Every
    device is validated by ``resolve_device`` (so ``cuda`` needs a card),
    and all must be of one type.
    """

    def __init__(self, devices, axis_names=("model",)):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"devices have {arr.ndim} dims but axis_names "
                f"{axis_names} name {len(axis_names)}"
            )
        if len(set(axis_names)) != len(axis_names) or arr.size == 0:
            raise ValueError(f"bad mesh: axes {axis_names}, {arr.size} devices")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            self.devices[pos] = resolve_device(arr[pos])
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got {types}")
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def first_device(self) -> torch.device:
        """The device results are gathered on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.device_type})"


def batch_axes(mesh: DeviceMesh) -> tuple:
    """The mesh's query (batch) axes, outermost first."""
    return tuple(a for a in _BATCH_AXES if a in mesh.axis_names)


def _layout(mesh: DeviceMesh, point_axis: str):
    """(positions, p_size, bsz): every mesh position as (pos, shard,
    batch slice), the point-axis size and the number of query slices.
    Query slices number the batch axes row-major (``pod`` outermost), as
    a ``PartitionSpec(("pod", "data"))`` sharding does."""
    if point_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {point_axis!r}")
    b_axes = batch_axes(mesh)
    extra = set(mesh.axis_names) - set(b_axes) - {point_axis}
    if extra:
        raise ValueError(
            f"mesh axes {sorted(extra)} are neither the point axis nor a "
            f"batch axis {_BATCH_AXES}"
        )
    shape = mesh.shape
    p_size = shape[point_axis]
    if p_size & (p_size - 1):
        raise ValueError(f"hypercube merge wants pow2 shards, got {p_size}")
    b_sizes = [shape[a] for a in b_axes]
    bsz = math.prod(b_sizes)
    p_dim = mesh.axis_names.index(point_axis)
    b_dims = [mesh.axis_names.index(a) for a in b_axes]
    positions = []
    for pos in np.ndindex(mesh.devices.shape):
        b = 0
        for dim, size in zip(b_dims, b_sizes):
            b = b * size + pos[dim]
        positions.append((pos, pos[p_dim], b))
    return positions, p_size, bsz


def _host_tensor(x, dtype) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` (a tensor stays on its device, an
    array becomes a CPU tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _partner(pos: tuple, p_dim: int, step: int) -> tuple:
    pos = list(pos)
    pos[p_dim] ^= step
    return tuple(pos)


def place_shards(points, mesh: DeviceMesh, point_axis: str = "model"):
    """Split (N, d) points row-wise into the point axis's P equal shards
    and put shard j on the device of every position whose point-axis
    coordinate is j (one copy per distinct device).  Returns an object
    array of the mesh's shape holding each position's (N/P, d) tensor."""
    _, p_size, _ = _layout(mesh, point_axis)
    pts = _host_tensor(points, torch.float32)
    n = pts.shape[0]
    if n % p_size:
        raise ValueError(
            f"{n} points do not split into {p_size} equal shards; the "
            f"point axis must divide N"
        )
    nl = n // p_size
    p_dim = mesh.axis_names.index(point_axis)
    copies: dict = {}
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(mesh.devices.shape):
        j, dev = pos[p_dim], mesh.devices[pos]
        key = (j, dev)
        if key not in copies:
            copies[key] = as_f32(pts[j * nl:(j + 1) * nl], dev)
        out[pos] = copies[key]
    return out


def _merge_topk(d_a, i_a, d_b, i_b, k: int):
    """The k smallest of two candidate lists laid end to end; a tie goes
    to the earlier column (``lax.top_k``'s order), so a stable sort."""
    d = torch.cat([d_a, d_b], 1)
    i = torch.cat([i_a, i_b], 1)
    sd, sel = torch.sort(d, dim=1, stable=True)
    return sd[:, :k], torch.gather(i, 1, sel[:, :k])


def hypercube_merge(lists: dict, mesh: DeviceMesh, point_axis: str, k: int):
    """log2(P) hypercube steps over per-position ``(d, idx, count)``
    lists (keyed by mesh position): at step s every position merges its
    own list with a copy of position ``i ^ s``'s, [own, partner], and adds
    the int32 counts.  Every step reads the lists of the step before."""
    p_size = mesh.shape[point_axis]
    p_dim = mesh.axis_names.index(point_axis)
    step = 1
    while step < p_size:
        new = {}
        for pos, (d, i, c) in lists.items():
            dev = d.device
            od, oi, oc = (t.to(dev) for t in lists[_partner(pos, p_dim, step)])
            md, mi = _merge_topk(d, i, od, oi, k)
            new[pos] = (md, mi, c + oc)
        lists = new
        step *= 2
    return lists


def _gather_slices(lists: dict, positions, bsz: int, dev):
    """Each query slice's answer from its position at point-axis
    coordinate 0, concatenated in slice order on ``dev``."""
    by_slice = {b: pos for pos, j, b in positions if j == 0}
    parts = [lists[by_slice[b]] for b in range(bsz)]
    return tuple(torch.cat([p[t].to(dev) for p in parts], 0)
                 for t in range(3))


def make_distributed_knn(
    mesh: DeviceMesh,
    k: int,
    *,
    radius: float = math.inf,
    point_axis: str = "model",
):
    """Returns fn(points, queries, query_ids).

    points: the placed shards (``place_shards``) or an (N, d) array /
            tensor, placed on the call.
    queries: (Q, d), split over the batch axes (Q divisible by their
             product).
    query_ids: (Q,) global point index of each query for self-exclusion
               (-1 = no exclusion).
    Returns (d2 (Q, k), idx (Q, k) global indices, counts (Q,)) tensors on
    the mesh's first device; empty slots are (inf, N).
    """
    positions, p_size, bsz = _layout(mesh, point_axis)
    thr = float(np.float32(radius) ** 2) if np.isfinite(radius) else math.inf

    def fn(points, queries, query_ids):
        placed = points
        if not (isinstance(points, np.ndarray) and points.dtype == object):
            placed = place_shards(points, mesh, point_axis)
        q = _host_tensor(queries, torch.float32)
        qid = _host_tensor(query_ids, torch.int64)
        n_q = q.shape[0]
        if n_q % bsz:
            raise ValueError(f"{n_q} queries do not split into {bsz} slices")
        qs = n_q // bsz
        lists = {}
        for pos, shard, b in positions:
            dev = mesh.devices[pos]
            pts_l = placed[pos]
            n_local = pts_l.shape[0]
            n_global = n_local * p_size
            q_l = as_f32(q[b * qs:(b + 1) * qs], dev)
            # out-of-shard ids (negative or >= n_local) never match
            qid_l = (qid[b * qs:(b + 1) * qs] - shard * n_local).to(
                device=dev, dtype=torch.int32).contiguous()
            d2, idx, cnt = topk_engine(q_l, qid_l, pts_l, thr, k=int(k))
            idx = torch.where(idx < n_local, idx + shard * n_local,
                              n_global).to(torch.int32)
            lists[pos] = (d2, idx, cnt)
        lists = hypercube_merge(lists, mesh, point_axis, int(k))
        return _gather_slices(lists, positions, bsz, mesh.first_device)

    return fn


def distributed_trueknn(
    points,
    k: int,
    mesh: DeviceMesh,
    *,
    queries=None,
    start_radius=None,
    growth: float = 2.0,
    max_rounds: int = 32,
    points_device=None,
    point_axis: str = "model",
):
    """Multi-round unbounded kNN over mesh-sharded points (host-orchestrated
    rounds, paper Alg. 3).  Query retirement compacts between rounds.

    Returns ``(dists, idxs, rounds, n_tests)``.  ``n_tests`` counts
    candidate distance evaluations (the paper's work metric): the dense
    streaming engine evaluates every (query, point) pair each round, so the
    count is exactly ``sum over rounds of padded_alive * N`` — padding rows
    included, since they are real work on the mesh.  With the dense engine
    one pass is already exact; the rounds exist so radius-bounded engines
    (``distributed_grid``) slot into the same orchestration.
    ``points_device`` is the cloud already placed by ``place_shards`` (a
    resident index places it once); one-shot callers pay the transfer here.
    """
    pts = np.asarray(points, np.float32)
    n, d = pts.shape
    if queries is None:
        q_all = pts
        qid_all = np.arange(n, dtype=np.int32)
    else:
        q_all = np.asarray(queries, np.float32)
        qid_all = np.full((q_all.shape[0],), -1, np.int32)
    q_total = q_all.shape[0]
    _, _, bsz = _layout(mesh, point_axis)
    if points_device is None:
        points_device = place_shards(pts, mesh, point_axis)
    r = float(start_radius) if start_radius else sample_start_radius(
        torch.as_tensor(pts, device=mesh.first_device))

    out_d = np.full((q_total, k), np.inf, np.float32)
    out_i = np.full((q_total, k), n, np.int32)
    alive = np.arange(q_total)

    def run_round(q_sub, qid_sub, rad):
        m = q_sub.shape[0]
        m_pad = max(bsz, 1 << max(0, (m - 1).bit_length()))
        q = np.zeros((m_pad, d), np.float32)
        q[:m] = q_sub
        qid = np.full((m_pad,), -1, np.int32)
        qid[:m] = qid_sub
        fn = make_distributed_knn(mesh, k, radius=rad, point_axis=point_axis)
        d2, idx, cnt = fn(points_device, q, qid)
        tests = m_pad * n  # dense engine: every padded row vs every point
        return (d2.cpu().numpy()[:m], idx.cpu().numpy()[:m],
                cnt.cpu().numpy()[:m], tests)

    rounds = 0
    n_tests = 0
    while alive.size and rounds < max_rounds:
        d2, idx, cnt, tests = run_round(q_all[alive], qid_all[alive], r)
        n_tests += tests
        resolved = cnt >= k
        done = alive[resolved]
        out_d[done] = d2[resolved]
        out_i[done] = idx[resolved]
        alive = alive[~resolved]
        r *= growth
        rounds += 1

    if alive.size:  # tail: one exact unbounded pass
        d2, idx, _, tests = run_round(q_all[alive], qid_all[alive], np.inf)
        n_tests += tests
        out_d[alive] = d2
        out_i[alive] = idx

    return np.sqrt(np.maximum(out_d, 0)), out_i, rounds, n_tests
