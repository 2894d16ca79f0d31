"""The radius-growth loop on the device with one host sync (port of
``repro.core.fused_loop``).

``build_schedule`` is the reference's host code: it transcribes the host
loop's control flow (geometric growth, stop/cap handling, the
brute-equivalent guard, the 4x-extent clamp) into the list of rounds the
device may need, each with its lattice-snapped grid from the index's
cache.

``fused_search`` then enqueues one grid-round launch per scheduled round
and, where the schedule has a tail, one masked brute launch — with no
host sync in between.  The state the reference carries through its
``lax.while_loop`` lives in device tensors that the kernels update in
place: the best-k lists, the ``unres`` mask (a round skips rows already
resolved and REPLACES the rows it runs), ``res_round``, the per-round
test counters, the walk's per-round distance counters and a per-round
"executed" flag.  A round launched after
every row has resolved does nothing, so ``n_executed`` (the sum of the
flags) equals the reference's while-loop count.  The brute tail runs only
on rows still unresolved.  The single host sync is the final fetch.

On the card a search that comes again is replayed from a CUDA graph of
its launches (``FusedGraphs``): the same launches and outputs, with no
host work between them.

Under a recording ``torch.profiler`` each phase is a span
(``repro_torch.fused.upload``, ``.round`` a launch, ``.tail``, ``.fetch``;
a replayed search has ``.upload``, ``.replay`` and ``.fetch``).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch

from ..kernels.build import add_launches, launch_snapshot, launches_since
from ..kernels.ops import as_f32, sqrt32
from .brute import _brute_impl
from .fixed_radius import grid_round, round_design, walk_order
from .grid import _next_pow2
from .spans import span

__all__ = ["FusedSchedule", "FusedResult", "FusedGraphs", "build_schedule",
           "fused_search"]


@dataclasses.dataclass(frozen=True)
class FusedSchedule:
    """The data-independent round plan of one fused search.

    ``radii[t]`` is round t's search radius and ``grids[t]`` its
    lattice-snapped grid.  ``tail_mode`` says what finishes still-unresolved
    queries after the last round: ``"plain"`` (exact brute tail,
    unbounded), ``"capped"`` (brute tail re-cut at the hybrid cap), or
    ``"none"`` (stop_radius tails keep their partial lists).
    """

    radii: tuple
    grids: tuple
    cache_hits: tuple
    tail_mode: str
    stop_radius: object  # Optional[float]

    def signature(self) -> tuple:
        """Shape-defining key of a search: round count, per-round grid
        shapes, tail form."""
        return (
            len(self.radii),
            tuple((g.table_size, g.cap) for g in self.grids),
            self.tail_mode,
        )


@dataclasses.dataclass
class FusedResult:
    """Device outputs of one fused search, fetched to the host.

    ``dists`` are true L2 (sqrt applied on the device); ``unresolved`` is
    the pre-tail mask; ``tests[t]`` counts candidate distance evaluations
    charged to round t; ``n_executed`` is how many scheduled rounds found
    an unresolved row.  ``walked[t]`` says whether round t took the
    sub-grid walk, and ``evaluated[t]`` holds the distances the walk
    computed there (0 for the other designs, which compute one a test).
    """

    dists: np.ndarray  # (Q, k) float32
    idxs: np.ndarray  # (Q, k) int32
    found: np.ndarray  # (Q,) int32
    unresolved: np.ndarray  # (Q,) bool, pre-tail
    resolved_round: np.ndarray  # (Q,) int32, -1 = never in-loop
    tests: np.ndarray  # (n_sched,) int64
    n_executed: int
    q_pad: int
    evaluated: np.ndarray  # (n_sched,) int64
    walked: tuple  # (n_sched,) bool


def build_schedule(index, r0: float, *, stop_radius=None,
                   cap_exact: bool = False) -> FusedSchedule:
    """Transcribe the host loop's round schedule for a start radius
    (``repro.core.fused_loop.build_schedule``, verbatim).  Grids come from
    ``index._grid_for`` in the host loop's call order, so the lattice
    cache sees the same build/hit sequence."""
    radii, grids, hits = [], [], []
    r = float(r0)
    ridx = 0
    force_brute_tail = False
    clamp_r = 4.0 * index._extent
    while ridx < index._max_rounds:
        at_cap = False
        if stop_radius is not None:
            if cap_exact:
                # hybrid cap: boundary round searches exactly the cap
                # radius (jump straight there on the last budgeted round)
                if r >= stop_radius or ridx == index._max_rounds - 1:
                    r = float(stop_radius)
                    at_cap = True
            elif r > stop_radius:
                break
        grid, hit = index._grid_for(r)
        radii.append(r)
        grids.append(grid)
        hits.append(hit)
        ridx += 1
        if at_cap:
            break
        # single-cell grid covering the cloud diagonal: the round was a
        # brute-force pass; if queries still don't resolve, growing cannot
        # help — the exact tail finishes them
        if all(res == 1 for res in grid.res) and r * r >= index._sq_diag:
            force_brute_tail = True
            break
        r *= index._growth
        if r > clamp_r:
            r = clamp_r
    tail_mode = (
        ("capped" if cap_exact else "plain")
        if (force_brute_tail or stop_radius is None)
        else "none"
    )
    return FusedSchedule(
        radii=tuple(radii),
        grids=tuple(grids),
        cache_hits=tuple(hits),
        tail_mode=tail_mode,
        stop_radius=stop_radius,
    )


def _search_on_device(points, schedule: FusedSchedule, q, qid, k: int,
                      chunk: int, walked: tuple):
    """The launches of one search, none of which reads the host: the
    state, a grid round a scheduled round, the tail and the square roots.
    Returns the device outputs (dists, idxs, found, unres, res_round,
    counters (2, n_sched): tests and the walk's distances, executed)."""
    dev = q.device
    q_total = q.shape[0]
    n_sched = len(schedule.radii)
    n = schedule.grids[0].n_points
    best_d2 = torch.full((q_total, k), math.inf, dtype=torch.float32,
                         device=dev)
    best_i = torch.full((q_total, k), n, dtype=torch.int32, device=dev)
    found = torch.zeros((q_total,), dtype=torch.int32, device=dev)
    unres = torch.isfinite(q[:, 0]).to(torch.uint8)
    res_round = torch.full((q_total,), -1, dtype=torch.int32, device=dev)
    # the rounds' tests and the walk's distances, read in one copy
    counters = torch.zeros((2, n_sched), dtype=torch.int64, device=dev)
    tests, evaluated = counters[0], counters[1]
    executed = torch.zeros((n_sched,), dtype=torch.int32, device=dev)
    # host numpy f32 square == device f32 square (same IEEE multiply)
    r2s = np.asarray(schedule.radii, np.float32) ** 2
    perm = None  # the walk's row order, sorted once a search
    for t, grid in enumerate(schedule.grids):
        with span("repro_torch.fused.round"):
            if walked[t] and perm is None:
                perm = walk_order(q, grid, unres)
            grid_round(
                points, grid, q, qid, float(r2s[t]), k,
                out=(best_d2, best_i, found), tests=tests[t:t + 1],
                unres=unres, res_round=res_round, t=t,
                executed=executed[t:t + 1], evaluated=evaluated[t:t + 1],
                perm=perm if walked[t] else None, chunk=chunk,
            )
    if schedule.tail_mode != "none":
        # exact oracle for the rows the loop left unresolved (the mask is
        # only read), replaced wholesale as the host loop does; the
        # hybrid re-cut and the found recount are host-side post-filters
        # in both loops
        with span("repro_torch.fused.tail"):
            _brute_impl(points, q, qid, k=k, metric="l2", row_mask=unres,
                        out=(best_d2, best_i))
    return (sqrt32(best_d2), best_i, found, unres, res_round, counters,
            executed)


class FusedGraphs:
    """The fused searches of one index on the card, captured as CUDA
    graphs and replayed.

    A search's launches depend only on its schedule (grids and radii), the
    rows' count and the resident cloud, never on the rows' values, and
    none reads the host.  So a search is captured the second time its key
    comes (the first ran eagerly and built every lazy kernel, cache and
    workspace size), and later ones replay it: one graph launch in place
    of the ~10^2 launches of a search and the host work between them.  The
    graph reads the rows from its own buffers, which each replay fills
    (a self query of the resident cloud reads it in place), and writes
    outputs that the fetch copies before the next replay (``lock`` holds
    a replay's buffers until then).  Every launch and every output is the
    eager search's.  The ``MAX_ENTRIES`` searches used last are kept with
    their buffers and grids (a cell's searches have one key); a capture
    that fails leaves its key eager.  ``captures``, ``replays`` and
    ``failures`` count what happened."""

    MAX_ENTRIES = 2
    #: keys seen once that are kept (forgotten all at once past it)
    MAX_SEEN = 64

    def __init__(self):
        self.lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._seen: set = set()
        self._failed: set = set()
        self.captures = 0
        self.replays = 0
        self.failures = 0

    @staticmethod
    def key(points, schedule: FusedSchedule, queries, k: int, chunk: int):
        """What a captured search depends on: the cloud, the schedule's
        grids (by identity: an entry holds them) and radii, the tail, the
        rows' shape (and whether they are the resident cloud), k."""
        shape = tuple(queries.shape)
        return (id(points), tuple(id(g) for g in schedule.grids),
                tuple(schedule.radii), schedule.tail_mode, shape,
                queries is points, int(k), int(chunk))

    def run(self, points, schedule, queries, query_ids, k, chunk, walked):
        """The device outputs of one search (``_search_on_device``'s), by
        replay where the search was captured; None where it runs eagerly
        (``fused_search`` then runs it)."""
        key = self.key(points, schedule, queries, k, chunk)
        entry = self._entries.get(key)
        if entry is None:
            if key in self._failed:
                return None
            if key not in self._seen:
                if len(self._seen) >= self.MAX_SEEN:
                    self._seen.clear()
                self._seen.add(key)
                return None
            entry = self._capture(key, points, schedule, queries, query_ids,
                                  k, chunk, walked)
            if entry is None:
                return None
        self._entries.move_to_end(key)
        graph, q_buf, qid_buf, outs, launches, _ = entry
        with span("repro_torch.fused.upload"):
            if q_buf is not None:
                q_buf.copy_(torch.as_tensor(queries, dtype=torch.float32))
            qid_buf.copy_(torch.as_tensor(query_ids, dtype=torch.int32))
        with span("repro_torch.fused.replay"):
            graph.replay()
        add_launches(launches)
        self.replays += 1
        return outs

    def _capture(self, key, points, schedule, queries, query_ids, k, chunk,
                 walked):
        dev = points.device
        self_rows = queries is points
        q_buf = None if self_rows else as_f32(queries, dev).clone()
        qid_buf = torch.as_tensor(query_ids, dtype=torch.int32,
                                  device=dev).contiguous().clone()
        before = launch_snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            torch.cuda.synchronize(dev)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = _search_on_device(
                    points, schedule, points if self_rows else q_buf,
                    qid_buf, k, chunk, walked)
        except RuntimeError:
            self._failed.add(key)
            self.failures += 1
            return None
        finally:
            # a capture launches nothing: its replays count its launches
            launches = launches_since(before)
            add_launches(launches, -1)
        entry = (graph, q_buf, qid_buf, outs, launches, schedule.grids)
        self._entries[key] = entry
        while len(self._entries) > self.MAX_ENTRIES:
            self._entries.popitem(last=False)
        self.captures += 1
        return entry


def fused_search(points, schedule: FusedSchedule, queries, query_ids,
                 k: int, *, chunk: int = 2048,
                 graphs: FusedGraphs = None) -> FusedResult:
    """Run one whole multi-round search with a single host sync.

    ``points`` is the resident cloud (a tensor on the grids' device),
    ``queries`` (Q, d) with ``query_ids`` (Q,) int32 (the dataset id for
    self-queries, N otherwise).  Rows with a non-finite first coordinate
    start resolved, as in the reference.  ``graphs``: the index's
    ``FusedGraphs``, which replays a search it has captured (on the card).
    """
    dev = points.device
    k = int(k)
    walked = tuple(
        round_design(grid, float(np.float32(r) ** 2), k, True) == "walk"
        for r, grid in zip(schedule.radii, schedule.grids))
    if graphs is not None and dev.type == "cuda":
        with graphs.lock:  # one replay's buffers until its fetch is done
            outs = graphs.run(points, schedule, queries, query_ids, k, chunk,
                              walked)
            if outs is not None:
                return _fetch(outs, walked)
    with span("repro_torch.fused.upload"):
        q = as_f32(queries, dev)
        qid = torch.as_tensor(query_ids, dtype=torch.int32,
                              device=dev).contiguous()
    return _fetch(_search_on_device(points, schedule, q, qid, k, chunk,
                                    walked), walked)


def _fetch(outs, walked: tuple) -> FusedResult:
    """The device outputs of a search read to the host: the one sync."""
    best_d, best_i, found, unres, res_round, counters, executed = outs
    with span("repro_torch.fused.fetch"):
        dists = best_d.cpu().numpy()  # the one host sync
        counts = counters.cpu().numpy()
        return FusedResult(
            dists=dists,
            idxs=best_i.cpu().numpy(),
            found=found.cpu().numpy(),
            unresolved=unres.cpu().numpy().astype(bool),
            resolved_round=res_round.cpu().numpy(),
            tests=counts[0],
            n_executed=int(executed.cpu().numpy().sum()),
            q_pad=_next_pow2(max(best_i.shape[0], 1)),
            evaluated=counts[1],
            walked=walked,
        )
