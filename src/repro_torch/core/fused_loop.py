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
test counters and a per-round "executed" flag.  A round launched after
every row has resolved does nothing, so ``n_executed`` (the sum of the
flags) equals the reference's while-loop count.  The brute tail runs only
on rows still unresolved.  The single host sync is the final fetch.

Under a recording ``torch.profiler`` each phase is a span
(``repro_torch.fused.upload``, ``.round`` a launch, ``.tail``, ``.fetch``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.ops import as_f32, sqrt32
from .brute import _brute_impl
from .fixed_radius import grid_round
from .grid import _next_pow2
from .spans import span

__all__ = ["FusedSchedule", "FusedResult", "build_schedule", "fused_search"]


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
    an unresolved row.
    """

    dists: np.ndarray  # (Q, k) float32
    idxs: np.ndarray  # (Q, k) int32
    found: np.ndarray  # (Q,) int32
    unresolved: np.ndarray  # (Q,) bool, pre-tail
    resolved_round: np.ndarray  # (Q,) int32, -1 = never in-loop
    tests: np.ndarray  # (n_sched,) int64
    n_executed: int
    q_pad: int


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


def fused_search(points, schedule: FusedSchedule, queries, query_ids,
                 k: int, *, chunk: int = 2048) -> FusedResult:
    """Run one whole multi-round search with a single host sync.

    ``points`` is the resident cloud (a tensor on the grids' device),
    ``queries`` (Q, d) with ``query_ids`` (Q,) int32 (the dataset id for
    self-queries, N otherwise).  Rows with a non-finite first coordinate
    start resolved, as in the reference.
    """
    dev = points.device
    n_sched = len(schedule.radii)
    k = int(k)
    with span("repro_torch.fused.upload"):
        q = as_f32(queries, dev)
        qid = torch.as_tensor(query_ids, dtype=torch.int32,
                              device=dev).contiguous()
        q_total = q.shape[0]
        n = schedule.grids[0].n_points

        best_d2 = torch.full((q_total, k), math.inf, dtype=torch.float32,
                             device=dev)
        best_i = torch.full((q_total, k), n, dtype=torch.int32, device=dev)
        found = torch.zeros((q_total,), dtype=torch.int32, device=dev)
        unres = torch.isfinite(q[:, 0]).to(torch.uint8)
        res_round = torch.full((q_total,), -1, dtype=torch.int32, device=dev)
        tests = torch.zeros((n_sched,), dtype=torch.int64, device=dev)
        executed = torch.zeros((n_sched,), dtype=torch.int32, device=dev)
        # host numpy f32 square == device f32 square (same IEEE multiply)
        r2s = np.asarray(schedule.radii, np.float32) ** 2

    for t, grid in enumerate(schedule.grids):
        with span("repro_torch.fused.round"):
            grid_round(
                points, grid, q, qid, float(r2s[t]), k,
                out=(best_d2, best_i, found), tests=tests[t:t + 1],
                unres=unres, res_round=res_round, t=t,
                executed=executed[t:t + 1], chunk=chunk,
            )
    if schedule.tail_mode != "none":
        # exact oracle for the rows the loop left unresolved (the mask is
        # only read), replaced wholesale as the host loop does; the
        # hybrid re-cut and the found recount are host-side post-filters
        # in both loops
        with span("repro_torch.fused.tail"):
            _brute_impl(points, q, qid, k=k, metric="l2", row_mask=unres,
                        out=(best_d2, best_i))
    with span("repro_torch.fused.fetch"):
        best_d = sqrt32(best_d2)
        return FusedResult(
            dists=best_d.cpu().numpy(),  # the one host sync
            idxs=best_i.cpu().numpy(),
            found=found.cpu().numpy(),
            unresolved=unres.cpu().numpy().astype(bool),
            resolved_round=res_round.cpu().numpy(),
            tests=tests.cpu().numpy(),
            n_executed=int(executed.sum().item()),
            q_pad=_next_pow2(max(q_total, 1)),
        )
