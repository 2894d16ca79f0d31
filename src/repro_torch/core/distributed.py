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
queries through the mesh.

:class:`PlacedFabric` is the second placement primitive here, built for
the sharded backend's ``placement="devices"``: it pins an arbitrary list
of per-shard point blocks to the positions of a 1-D mesh (a padded slot
axis; empty slots launch nothing) and answers one per-slot top-k/count
dispatch per call, or a whole shared-cut round schedule on the index's
device (``fused_rounds``).  Every slot is one ``pairwise_topk`` launch.
It has no merge network of its own beyond the fused loop's lexicographic
(distance, global index) sort: per-slot lists return to the sharded
backend's exact host merges, so placing the shards never changes an
answer bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.ops import as_f32, sqrt32, topk_engine
from .sampling import sample_start_radius

__all__ = [
    "DeviceMesh",
    "batch_axes",
    "place_shards",
    "make_distributed_knn",
    "distributed_trueknn",
    "hypercube_merge",
    "PLACED_FORMS",
    "FORM_METRIC",
    "PlacedFabric",
]

_BATCH_AXES = ("pod", "data")


class DeviceMesh:
    """A grid of devices with named axes (the port's ``jax.sharding.Mesh``).

    ``devices`` is a nested list or array of devices (``torch.device`` or
    strings such as ``"cuda"`` / ``"cpu"``) whose number of dimensions is
    ``len(axis_names)``.  A device may appear at several positions.  Every
    device is validated by ``resolve_device`` (so ``cuda`` needs a card),
    except ``meta``, which the dry-run's production meshes hold (shapes
    and shardings without storage); all must be of one type.
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
            dev = torch.device(arr[pos])
            self.devices[pos] = dev if dev.type == "meta" else resolve_device(dev)
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


# -- placed shard fabric ------------------------------------------------------

#: the distance forms a placed slot dispatch computes, each mapped to the
#: ``pairwise_topk`` metric that runs it.  Each replicates, op for op, the
#: float32 arithmetic of the engine the sharded backend's per-child path
#: would have used for the same route, so host folds stay bit-identical:
#:   sq_l2   — squared L2 in the diff form at every d (``fixed_radius`` /
#:             low-d brute): the kernel's ``l2diff``; callers take the
#:             square root.
#:   l1      — |diff| summed over the axes (the brute engine's knn form;
#:             the reference's ``jnp.sum``, which XLA reduces in axis order
#:             at the dims probed, d <= 16).
#:   l1_acc  — |diff| accumulated per axis in order (the Pallas kernel's
#:             range form).  Both L1 forms are the kernel's sequential L1.
#:   linf    — running max of |diff|.
FORM_METRIC = {"sq_l2": "l2diff", "l1": "l1", "l1_acc": "l1",
               "linf": "linf"}
PLACED_FORMS = tuple(FORM_METRIC)


class PlacedFabric:
    """Per-shard point blocks pinned to the positions of a 1-D mesh.

    Slot layout: ``n_slots`` is the shard count rounded UP to a multiple
    of the mesh size; slot ``j`` lives on position ``j // (n_slots /
    n_devices)``, whose device holds a zero-padded ``(block_rows, dim)``
    block for it.  Empty slots (``(-1, 0, 0)``) are masked: they launch
    nothing.  Hot shards can be *split* across free slots
    (:meth:`rebalance`): each slot owns a contiguous ascending row range
    of its shard, so the union of slot answers is exactly the shard's
    answer and merges stay order-exact.

    The fabric is space-aware: metric routes that search a transformed
    cloud (cosine's normalize-then-L2) register the transform once
    (:meth:`add_space`) and dispatch against lazily placed transformed
    blocks.

    ``mesh`` is a 1-D ``DeviceMesh`` (any axis name; a device may sit at
    several positions); ``device`` is where the fused loop's carry lives
    (the mesh's first device by default).  ``dispatches`` counts calls of
    :meth:`topk` and :meth:`fused_rounds`, the reference's one device
    program each; ``syncs`` counts the blocking device-to-host reads they
    make (one per device with a launched slot in ``topk``, after every
    slot has launched; one per round and one for the result in
    ``fused_rounds``); kernel launches are counted apart
    (``kernels.build.launch_counts``).
    """

    def __init__(self, blocks, *, mesh: DeviceMesh, device=None):
        blocks = [np.ascontiguousarray(b, np.float32) for b in blocks]
        if not blocks:
            raise ValueError("PlacedFabric needs at least one shard block")
        if mesh.devices.ndim != 1:
            raise ValueError(f"PlacedFabric needs a 1-D mesh, got {mesh}")
        self.mesh = mesh
        self.device = (mesh.first_device if device is None
                       else resolve_device(device))
        self.n_devices = int(mesh.devices.size)
        self._spaces = {"raw": blocks}  # name -> per-shard host blocks
        n_shards = len(blocks)
        self.n_slots = -(-n_shards // self.n_devices) * self.n_devices
        self.block_rows = max(max(b.shape[0] for b in blocks), 1)
        self.dim = blocks[0].shape[1]
        #: slot j -> (shard id, row lo, row hi) within that shard's block;
        #: (-1, 0, 0) marks an empty (padding or not-yet-used) slot
        self.slots = [(s, 0, blocks[s].shape[0]) for s in range(n_shards)]
        self.slots += [(-1, 0, 0)] * (self.n_slots - n_shards)
        self.dispatches = 0
        self.syncs = 0
        self.rebalances = 0
        self._dev_blocks: dict = {}  # space -> per-slot (nv, dim) or None

    # -- spaces ------------------------------------------------------------

    def add_space(self, name: str, transform) -> None:
        """Register a transformed search space (e.g. cosine's normalized
        cloud); ``transform`` maps one host block (n, dim) -> (n, dim)."""
        if name not in self._spaces:
            self._spaces[name] = [
                transform(b) if b.size else b for b in self._spaces["raw"]
            ]

    def has_space(self, name: str) -> bool:
        return name in self._spaces

    # -- placement ---------------------------------------------------------

    def slot_device(self, j: int) -> torch.device:
        return self.mesh.devices.flat[j // (self.n_slots // self.n_devices)]

    def _placed_blocks(self, space: str) -> list:
        """Per slot, the valid rows of its zero-padded block (a view of
        its position's (slots per position, B, dim) tensor), None for an
        empty slot."""
        placed = self._dev_blocks.get(space)
        if placed is None:
            host = self._spaces[space]
            g = self.n_slots // self.n_devices
            placed = []
            for pos in range(self.n_devices):
                group = self.slots[pos * g:(pos + 1) * g]
                arr = np.zeros((g, self.block_rows, self.dim), np.float32)
                for jl, (s, lo, hi) in enumerate(group):
                    if s >= 0 and hi > lo:
                        arr[jl, :hi - lo] = host[s][lo:hi]
                blk = torch.from_numpy(arr).to(self.mesh.devices.flat[pos])
                placed += [blk[jl, :hi - lo] if s >= 0 and hi > lo else None
                           for jl, (s, lo, hi) in enumerate(group)]
            self._dev_blocks[space] = placed
        return placed

    def _slot_call(self, j: int, blk, metric: str, q_dev: dict, q, mask,
                   k: int, thr: float):
        """One ``pairwise_topk`` launch of slot ``j`` over the rows
        ``mask`` selects; unselected rows keep ``(inf, B)`` and count 0."""
        dev = self.slot_device(j)
        if dev not in q_dev:
            q_dev[dev] = q.to(dev).contiguous()
        qd = q_dev[dev]
        m = qd.shape[0]
        out = (torch.full((m, k), math.inf, dtype=torch.float32, device=dev),
               torch.full((m, k), self.block_rows, dtype=torch.int32,
                          device=dev),
               torch.zeros((m,), dtype=torch.int32, device=dev))
        none = torch.full((m,), -1, dtype=torch.int32, device=dev)
        d, idx, cnt = topk_engine(qd, none, blk, thr, k=k, metric=metric,
                                  row_mask=mask.to(dev, torch.uint8),
                                  out=out)
        # the kernel's empty slot is its n (the slot's valid rows)
        idx = torch.where(idx == blk.shape[0], self.block_rows, idx)
        return d, idx, cnt

    # -- the per-slot dispatch ---------------------------------------------

    def topk(self, space: str, form: str, queries, visit_slots, k: int,
             threshold: float = math.inf):
        """One dispatch: the dense top-k of every slot block against
        ``queries`` plus the per-(slot, query) count of candidates with
        ``dist <= threshold`` (float32), one kernel launch per slot that
        has a visited row.

        queries: (Qp, dim) float32.
        visit_slots: (n_slots, Qp) bool — False pairs contribute nothing.
        Returns host arrays ``(d (slots, Qp, k) raw form distances,
        idx (slots, Qp, k) slot-local rows — ``block_rows`` = no candidate,
        cnt (slots, Qp) int32)``.
        """
        if form not in PLACED_FORMS:
            raise ValueError(f"unknown placed form {form!r}")
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32))
        vm = np.ascontiguousarray(visit_slots, bool)
        if vm.shape != (self.n_slots, q.shape[0]):
            raise ValueError(f"visit mask {vm.shape}, want "
                             f"{(self.n_slots, q.shape[0])}")
        k = int(k)
        qp = q.shape[0]
        d = np.full((self.n_slots, qp, k), np.inf, np.float32)
        idx = np.full((self.n_slots, qp, k), self.block_rows, np.int32)
        cnt = np.zeros((self.n_slots, qp), np.int32)
        thr = float(np.float32(threshold))
        q_dev: dict = {}
        launched: dict = {}  # device -> [(slot, (d, idx, cnt))]
        for j, blk in enumerate(self._placed_blocks(space)):
            if blk is None or not vm[j].any():
                continue
            res = self._slot_call(j, blk, FORM_METRIC[form], q_dev, q,
                                  torch.from_numpy(vm[j]), k, thr)
            launched.setdefault(self.slot_device(j), []).append((j, res))
        # every slot is launched before the first read; then one copy per
        # device carries its slots' (d, idx, cnt) as one int32 buffer
        for parts in launched.values():
            buf = torch.cat([
                torch.cat([dj.view(torch.int32).reshape(-1), ij.reshape(-1),
                           cj]) for _, (dj, ij, cj) in parts]).cpu().numpy()
            self.syncs += 1
            step = qp * k
            for n, (j, _) in enumerate(parts):
                row = buf[n * (2 * step + qp):(n + 1) * (2 * step + qp)]
                d[j] = row[:step].view(np.float32).reshape(qp, k)
                idx[j] = row[step:2 * step].reshape(qp, k)
                cnt[j] = row[2 * step:]
        self.dispatches += 1
        return d, idx, cnt

    # -- the fused round loop ----------------------------------------------

    def fused_rounds(self, space: str, form: str, queries, self_ids,
                     bounds, floors, cover, alive0, slot_gmaps, *,
                     seed: float, growth: float, k_eff: int,
                     self_mode: bool, sentinel: int, max_rounds: int = 64):
        """Run the WHOLE shared-cut round schedule with its carry on the
        fabric's device: per round, one ``pairwise_topk`` launch per
        non-empty slot over the unresolved rows whose bound to the slot's
        shard is within the cut, the engine-exact radius cut, then the
        global-order merge, op for op the reference's device program.
        The schedule runs in float32, as the reference's does; the one
        host sync per round is the loop's ``unres.any()``.

        queries (Qp, dim) f32; self_ids (Qp,) global id or -1; bounds
        (Qp, n_shards) f32 deflated lower bounds; floors/cover (Qp,) f32;
        alive0 (Qp,) bool — padding rows False (they never search);
        slot_gmaps: per-slot (block_rows + 1,) local-row -> global-index
        lookups (row ``block_rows`` = ``sentinel``).

        Returns host arrays ``(pool_d (Qp, k_eff) mapped dists, pool_i
        (Qp, k_eff) global idxs, res_round (Qp,) resolution round or -1,
        radii (n_executed,) the schedule actually run, n_executed)``.
        """
        if form not in ("sq_l2", "l1", "linf"):
            raise ValueError(f"fused rounds take sq_l2, l1 or linf, not "
                             f"{form!r}")
        dev = self.device
        f32 = torch.float32

        def t32(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=dev)

        q = t32(queries)
        qp = q.shape[0]
        sid = torch.as_tensor(np.asarray(self_ids, np.int32), device=dev)
        b32, fl, cv = t32(bounds), t32(floors), t32(cover)
        al = np.ascontiguousarray(alive0, bool)
        cv_host = np.ascontiguousarray(cover, np.float32)
        seed32 = torch.tensor(np.float32(seed), device=dev)
        growth32 = torch.tensor(np.float32(growth), device=dev)
        cover_max = torch.tensor(
            np.float32(cv_host[al].max() if al.any() else 0.0), device=dev)
        tiny = torch.tensor(1e-12, dtype=f32, device=dev)
        zero = torch.tensor(0.0, dtype=f32, device=dev)
        k_eff = int(k_eff)
        kk = min(k_eff, self.block_rows)
        blocks = self._placed_blocks(space)
        gmaps = [
            None if blk is None else torch.as_tensor(
                np.asarray(slot_gmaps[j], np.int64),
                device=self.slot_device(j))
            for j, blk in enumerate(blocks)
        ]
        metric = FORM_METRIC[form]
        q_dev = {dev: q}

        def round_lists(r, unres):
            thr = r * r if form == "sq_l2" else r
            ds, iss = [], []
            for j, (s, _lo, _hi) in enumerate(self.slots):
                if blocks[j] is None:  # empty slot: nothing, no launch
                    ds.append(torch.full((qp, k_eff), math.inf, dtype=f32,
                                         device=dev))
                    iss.append(torch.full((qp, k_eff), sentinel,
                                          dtype=torch.int32, device=dev))
                    continue
                vm = unres & (b32[:, s] <= r)
                d, idx, _ = self._slot_call(j, blocks[j], metric, q_dev, q,
                                            vm, kk, math.inf)
                keep = d <= thr.to(d.device)
                dm = torch.where(keep, sqrt32(d) if form == "sq_l2" else d,
                                 math.inf)
                gi = torch.where(keep, gmaps[j][idx.long()],
                                 sentinel).to(torch.int32)
                if kk < k_eff:
                    pad = (qp, k_eff - kk)
                    dm = torch.cat([dm, dm.new_full(pad, math.inf)], 1)
                    gi = torch.cat([gi, gi.new_full(pad, sentinel)], 1)
                ds.append(dm.to(dev))
                iss.append(gi.to(dev))
            # the gathered lists, slot-major per row; ascending (dist,
            # global idx) — a stable sort by index, then by distance — is
            # the sequential ``topk_merge_rows`` fold (each global index
            # lives in exactly one slot)
            d_all, i_all = torch.cat(ds, 1), torch.cat(iss, 1)
            o = torch.sort(i_all, dim=1, stable=True).indices
            d_all, i_all = d_all.gather(1, o), i_all.gather(1, o)
            o = torch.sort(d_all, dim=1, stable=True).indices[:, :k_eff]
            return d_all.gather(1, o), i_all.gather(1, o)

        pool_d = torch.full((qp, k_eff), math.inf, dtype=f32, device=dev)
        pool_i = torch.full((qp, k_eff), sentinel, dtype=torch.int32,
                            device=dev)
        unres = torch.as_tensor(al, device=dev)
        res_round = torch.full((qp,), -1, dtype=torch.int32, device=dev)
        radii = torch.zeros((max_rounds,), dtype=f32, device=dev)
        r = zero
        t = 0
        while t < max_rounds:
            self.syncs += 1
            if not bool(unres.any()):
                break
            pend = torch.where(unres & torch.isfinite(fl), fl, math.inf)
            mn = pend.min()
            base = torch.where(torch.isfinite(mn), mn, zero)
            if t == 0:
                r1 = torch.maximum(torch.maximum(seed32, base), tiny)
            else:
                r1 = torch.maximum(r * growth32, base)
            # the last allowed round forces the cut past every cover
            # bound: the pool is then provably complete and every row
            # resolves, so a float32 growth stall can't spin forever
            if t >= max_rounds - 1:
                r1 = torch.maximum(r1, cover_max)
            nd, ni = round_lists(r1, unres)
            # REPLACE unresolved rows (the round is complete within its
            # cut; merging smaller-cut pools would duplicate)
            pool_d = torch.where(unres[:, None], nd, pool_d)
            pool_i = torch.where(unres[:, None], ni, pool_i)
            if self_mode:
                has_self = (pool_i == sid[:, None]).any(1)
                kth = torch.where(has_self, pool_d[:, k_eff - 1],
                                  pool_d[:, k_eff - 2])
            else:
                kth = pool_d[:, k_eff - 1]
            resolved = unres & ((kth <= r1) | (r1 >= cv))
            res_round = torch.where(resolved, t, res_round)
            radii[t] = r1
            unres = unres & ~resolved
            r = r1
            t += 1
        self.dispatches += 1
        self.syncs += 1
        return (pool_d.cpu().numpy(), pool_i.cpu().numpy(),
                res_round.cpu().numpy(), radii[:t].cpu().numpy(), t)

    # -- load spreading ----------------------------------------------------

    def slots_of(self, shard: int) -> list:
        return [j for j, (s, _, _) in enumerate(self.slots) if s == shard]

    def occupancy(self) -> list:
        """Points resident per mesh position (contiguous slot groups:
        position i owns slots [i*g, (i+1)*g))."""
        g = self.n_slots // self.n_devices
        return [
            int(sum(hi - lo for _, lo, hi in self.slots[i * g:(i + 1) * g]))
            for i in range(self.n_devices)
        ]

    def rebalance(self, shard: int) -> bool:
        """Split the named shard's largest slot across a free slot — two
        half-blocks of contiguous ascending rows, so slot answers union to
        exactly the shard answer.  Same slot count, same block rows; the
        blocks are placed again on the next dispatch.  Returns False when
        no free slot or nothing to split."""
        free = [j for j, (s, _, _) in enumerate(self.slots) if s < 0]
        if not free:
            return False
        mine = [(hi - lo, j) for j, (s, lo, hi) in enumerate(self.slots)
                if s == shard and hi - lo >= 2]
        if not mine:
            return False
        _, j = max(mine)
        s, lo, hi = self.slots[j]
        mid = (lo + hi) // 2
        self.slots[j] = (s, lo, mid)
        self.slots[free[0]] = (s, mid, hi)
        self._dev_blocks.clear()
        self.rebalances += 1
        return True
