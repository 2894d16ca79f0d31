"""TrueKNN backend — unbounded multi-round search (paper Alg. 3) as a
resident, warm-starting index.  ``backend="trueknn"`` (port of
``repro.api.backends.trueknn``; same schedule, caches and counters).

Round structure is the paper's: fixed-radius search over unresolved
queries, retire those with >= k in-radius neighbors, grow the radius,
re-fit the structure.  Two things make this an *index* rather than the old
free function:

* **Grid cache.**  Round radii are kept on a geometric lattice
  ``anchor * growth**j`` anchored at the first batch's start radius, and
  built grids are cached keyed by the lattice index ``j``.  A later batch
  whose rounds hit the same lattice points reuses the binning outright —
  the analogue of not re-fitting the BVH when the radius schedule repeats.
  Grids only ever snap *up* (cell size >= search radius), so exactness is
  untouched; radii at or beyond the cloud's extent share one single-cell
  (brute-equivalent) grid.

* **Warm-start radius.**  Each batch records the radius at which every
  query resolved; an EMA of a low percentile of that distribution seeds
  the next batch's start radius (snapped down to the lattice).  The first
  batch pays the paper's Alg. 2 sampling plus the tiny-radius ramp-up
  rounds; later batches start where the action is, so the serving loop
  runs fewer rounds per batch.

Safety: a round whose grid is a single cell and whose radius covers the
cloud diagonal is already a brute-force pass — if it still fails to
resolve every query (pathological inputs), the search falls through to the
exact brute oracle instead of spinning until ``max_rounds``.

On the card every grid round is one launch of the ``grid_round`` CUDA
kernel and the exact tail (and the Alg. 2 sampler) runs the
``pairwise_topk`` kernel; on the CPU their plain versions run.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from ...core.brute import brute_knn_engine
from ...core.fixed_radius import fixed_radius_round
from ...core.fused_loop import build_schedule, fused_search
from ...core.grid import build_grid
from ...core.result import KNNResult, RoundStats
from ...core.sampling import sample_start_radius
from ...core.spans import span
from ...kernels.ops import sqrt32
from ..index import NeighborIndex
from ..metrics import Metric
from ..query import HybridSpec, KnnSpec, RangeSpec
from ..registry import register_backend

__all__ = ["TrueKNNIndex"]


@register_backend("trueknn")
class TrueKNNIndex(NeighborIndex):
    """Resident multi-round unbounded-kNN index.

    cfg:
      growth:      per-round radius multiplier (> 1, default 2.0).
      max_rounds:  grid-round budget before the exact brute tail (64).
      chunk:       query rows per step of the plain (CPU) grid round
                   (2048); the CUDA kernel takes every row at once.
      seed:        RNG seed for start-radius sampling (paper Alg. 2).
      cache_grids: reuse lattice-snapped grids across rounds/batches (True).
      warm_start:  seed each batch's start radius from the previous
                   batches' resolved-radius EMA (True).
      warm_pct:    percentile of the resolved-radius distribution that the
                   warm start targets (25.0 — most queries still take a few
                   rounds, but the dead tiny-radius ramp is skipped).
      warm_ema:    EMA weight of the newest batch (0.3).
      max_cached_grids: LRU bound on the lattice grid cache, so per-call
                   explicit ``query(radius=...)`` values below the anchor
                   can't grow device memory without limit (64 — generous:
                   a normal radius schedule spans O(log(extent/r0)) lattice
                   points, well under the bound).
      fused:       run kNN/hybrid as one device-side round loop with a
                   single host sync instead of one sync per round (True;
                   see ``repro_torch.core.fused_loop``).  ``fused=False``
                   keeps the per-round host loop — the oracle the fused
                   loop is bit-identical to.
      device:      "cuda" (the card, default) or "cpu" (plain versions).

    ``KnnSpec(start_radius=...)`` overrides the start radius explicitly;
    ``KnnSpec(stop_radius=...)``
    is the paper's Sec. 5.5.1 early termination — tail queries keep the
    partial (< k) neighbor lists they found, with ``found`` recording how
    many.  ``HybridSpec(k, r)`` runs the same search with the cap searched
    *exactly* (the final round's radius is the cap itself, so no neighbor
    inside it is missed — unlike stop_radius, which only bounds the
    schedule).  ``RangeSpec(r)`` is a single counted round on the
    lattice-snapped cached grid.
    """

    def __init__(
        self,
        points,
        *,
        growth: float = 2.0,
        max_rounds: int = 64,
        chunk: int = 2048,
        seed: int = 0,
        cache_grids: bool = True,
        warm_start: bool = True,
        warm_pct: float = 25.0,
        warm_ema: float = 0.3,
        max_cached_grids: int = 64,
        fused: bool = True,
        device="cuda",
    ):
        super().__init__(points, device)
        if not growth > 1.0:
            raise ValueError("radius growth factor must exceed 1")
        self._growth = float(growth)
        self._fused = bool(fused)
        self._max_rounds = int(max_rounds)
        self._chunk = int(chunk)
        self._seed = int(seed)
        self._cache_grids = bool(cache_grids)
        self._warm_start = bool(warm_start)
        self._warm_pct = float(warm_pct)
        self._warm_ema = float(warm_ema)
        self._max_cached_grids = max(1, int(max_cached_grids))

        if self.n_points:
            ext = (self._pts.max(0) - self._pts.min(0)).astype(np.float64)
        else:
            # empty cloud: building must succeed (mutable composites hold
            # empty bases; the planner answers queries with empty shapes
            # before any engine runs), so the geometry degenerates to 0
            ext = np.zeros((max(self.dim, 1),), np.float64)
        self._extent = float(ext.max())
        self._sq_diag = float(np.sum(ext * ext))  # max pairwise dist^2 bound

        self._grids: dict = {}  # lattice index j -> Grid
        self._anchor: Optional[float] = None  # lattice base radius
        self._j_cap: Optional[int] = None  # lattice index of the 1-cell grid
        self._warm_r: Optional[float] = None  # resolved-radius EMA
        self._sampled_r: Optional[float] = None  # Alg. 2 result (per cloud)
        self._probe_cache: dict = {}  # grid table-sizing probe memo
        self._build_s = 0.0  # host seconds of the _grid_for calls that built

        self._c = {
            "batches": 0,
            "queries_served": 0,
            "grid_builds": 0,
            "grid_cache_hits": 0,
            "rounds": 0,
            "brute_tail_queries": 0,
            "dispatches": 0,  # device calls the host waits on (fused loop = 1)
            # self-batches reuse the resident device point buffer as the
            # query block instead of re-uploading the host array (counted
            # per dispatch that took the aliased path)
            "query_upload_skips": 0,
        }

    # -- radius lattice & grid cache --------------------------------------

    def _lattice_j(self, r: float) -> int:
        return math.ceil(math.log(r / self._anchor, self._growth) - 1e-9)

    def _set_anchor(self, r0: float) -> None:
        self._anchor = r0
        if self._extent <= r0:
            self._j_cap = 0
        else:
            self._j_cap = math.ceil(
                math.log(1.001 * self._extent / r0, self._growth)
            )

    def _grid_for(self, r: float):
        """Grid with cell size >= r (exactness invariant), cached on the
        radius lattice.  Returns (grid, cache_hit)."""
        t0 = time.perf_counter()
        if not self._cache_grids:
            g = build_grid(
                self._pts, r, device_points=self._pts_t,
                probe_cache=self._probe_cache,
            )
            self._c["grid_builds"] += 1
            self._build_s += time.perf_counter() - t0
            return g, False
        j = min(self._lattice_j(r), self._j_cap)
        g = self._grids.pop(j, None)
        if g is not None:
            self._grids[j] = g  # refresh LRU recency
            self._c["grid_cache_hits"] += 1
            return g, True
        # at the cap the grid is a single cell per axis (covers any radius);
        # below it, snap the build radius up to the lattice point.
        build_r = self._anchor * self._growth**j
        if j < self._j_cap:
            build_r = max(build_r, r)
        g = build_grid(
            self._pts, build_r, device_points=self._pts_t,
            probe_cache=self._probe_cache,
        )
        self._grids[j] = g
        self._c["grid_builds"] += 1
        while len(self._grids) > self._max_cached_grids:
            self._grids.pop(next(iter(self._grids)))
        self._build_s += time.perf_counter() - t0
        return g, False

    def _start_radius(self, radius: Optional[float],
                      shared: Optional[float] = None):
        """(radius, source) — explicit > warm EMA > shared plan seed >
        Alg. 2 sampling.  ``shared`` is a prepared plan's cross-plan
        warm-start hint (``PlanContext.warm_radius``): a scheduling seed
        only, so a scale mismatch costs at most extra ramp rounds, never
        correctness — and it is outranked the moment this index has warm
        state of its own."""
        if radius is not None:
            return max(float(radius), 1e-12), "explicit"
        if self._warm_start and self._warm_r is not None:
            r = self._warm_r
            if self._anchor is not None:
                # snap DOWN to the lattice: conservative (at most one extra
                # round) and guarantees grid-cache hits across batches
                j = min(
                    math.floor(
                        math.log(r / self._anchor, self._growth) + 1e-9
                    ),
                    self._j_cap,
                )
                r = self._anchor * self._growth**j
            return r, "warm"
        if shared is not None:
            return max(float(shared), 1e-12), "shared"
        if self._sampled_r is None:
            with span("repro_torch.trueknn.start_radius"):
                self._sampled_r = sample_start_radius(
                    self._pts_t, seed=self._seed
                )
        return self._sampled_r, "sampled"

    # -- the hot path ------------------------------------------------------

    def plan_details(self, spec, metric: Metric) -> tuple:
        if self._fused and isinstance(spec, (KnnSpec, HybridSpec)):
            return (
                f"fused/rounds<={self._max_rounds}",
                {"fused": True, "max_rounds": self._max_rounds},
                [],
            )
        return super().plan_details(spec, metric)

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        return self._run_knn(
            queries,
            spec.k,
            radius=spec.start_radius,
            stop_radius=spec.stop_radius,
            metric_name=metric.name,
            shared_radius=None if ctx is None else ctx.warm_radius,
            ctx=ctx,
        )

    def execute_hybrid(self, queries, spec: HybridSpec, metric: Metric,
                       ctx=None):
        # same search, but the cap is searched exactly: the last round's
        # radius is spec.radius itself, so hybrid answers match
        # knn-then-filter bit-for-bit (modulo ties) at multi-round cost.
        return self._run_knn(
            queries,
            spec.k,
            radius=None,
            stop_radius=spec.radius,
            cap_exact=True,
            metric_name=metric.name,
            ctx=ctx,
        )

    def execute_range(self, queries, spec: RangeSpec, metric: Metric,
                      ctx=None):
        from ..planner import range_from_counted_round

        r = float(spec.radius)
        if self._anchor is None:
            # range-first indexes anchor the lattice at the first radius
            self._set_anchor(max(r, 1e-12))
        n = self.n_points
        if queries is None:
            q = self._pts
            qid = np.arange(n, dtype=np.int32)
        else:
            q = np.asarray(queries, np.float32)
            qid = np.full((q.shape[0],), n, np.int32)
        t0 = time.perf_counter()
        grid, hit = self._grid_for(r)  # lattice-snapped: cell size >= r
        t_grid = time.perf_counter() - t0
        self._c["batches"] += 1
        self._c["queries_served"] += q.shape[0]
        # self-batch: the queries ARE the resident cloud, whose device
        # buffer is already up — hand it to the kernel instead of
        # re-uploading the host copy
        q_dev = self._pts_t if q is self._pts else q

        def round_fn(k):
            if q_dev is self._pts_t:
                self._c["query_upload_skips"] += 1
            d2, idx, found, n_tests = fixed_radius_round(
                self._pts_t, grid, q_dev, qid, r, int(k), chunk=self._chunk
            )
            self._c["rounds"] += 1
            self._c["dispatches"] += 1
            return (
                sqrt32(d2).cpu().numpy(),
                idx.cpu().numpy(),
                found.cpu().numpy(),
                n_tests,
            )

        return range_from_counted_round(
            round_fn,
            q_total=q.shape[0],
            cap=n - (1 if queries is None else 0),
            spec=spec,
            backend=self.backend_name,
            timings_extra={
                "plan": "native",
                "grid_builds": 0 if hit else 1,
                "grid_cache_hits": 1 if hit else 0,
                "grid_build_seconds": 0.0 if hit else t_grid,
            },
        )

    def _run_knn(
        self,
        queries,
        k: int,
        *,
        radius: Optional[float] = None,
        stop_radius: Optional[float] = None,
        cap_exact: bool = False,
        metric_name: str = "l2",
        shared_radius: Optional[float] = None,
        ctx=None,
    ) -> KNNResult:
        t_call = time.perf_counter()
        mark = self._marks()
        n = self.n_points
        if queries is None:
            q_all = self._pts
            qid_all = np.arange(n, dtype=np.int32)
            if k > n - 1:
                raise ValueError(
                    "k must be <= N-1 when the dataset queries itself"
                )
        else:
            q_all = np.asarray(queries, dtype=np.float32)
            qid_all = np.full((q_all.shape[0],), n, dtype=np.int32)
            if k > n:
                raise ValueError("k must be <= N")
        q_total = q_all.shape[0]

        r, r_source = self._start_radius(radius, shared_radius)
        # A warm/sampled start above stop_radius would break out before any
        # round ran and hand back an empty answer that depends on hidden
        # index state; clamp so at least one round searches at the stop
        # boundary (explicit radii are honored verbatim).
        if (
            stop_radius is not None
            and r_source != "explicit"
            and r > stop_radius
        ):
            r = float(stop_radius)
        if self._anchor is None:
            self._set_anchor(r)
        r0 = r

        if self._fused and q_total and n:
            res = self._run_knn_fused(
                q_all, qid_all, k, r0, r_source,
                stop_radius=stop_radius, cap_exact=cap_exact,
                metric_name=metric_name, ctx=ctx, t_call=t_call,
            )
            if res is not None:
                res.timings.update(self._since(mark))
                return res

        out_d = np.full((q_total, k), np.inf, dtype=np.float32)
        out_i = np.full((q_total, k), n, dtype=np.int32)
        found_all = np.zeros((q_total,), dtype=np.int64)
        resolved_at = np.full((q_total,), np.nan)  # radius that resolved each
        alive = np.arange(q_total, dtype=np.int64)

        rounds: list = []
        total_tests = 0
        ridx = 0
        force_brute_tail = False
        clamp_r = 4.0 * self._extent
        while alive.size and ridx < self._max_rounds:
            at_cap = False
            if stop_radius is not None:
                if cap_exact:
                    # hybrid cap: the boundary round searches exactly the
                    # cap radius (never skips past it), so every in-cap
                    # neighbor is surfaced.  Jump straight to the cap on
                    # the last budgeted round too — exactness beats
                    # schedule aesthetics.
                    if r >= stop_radius or ridx == self._max_rounds - 1:
                        r = float(stop_radius)
                        at_cap = True
                elif r > stop_radius:
                    break
            t0 = time.perf_counter()
            grid, hit = self._grid_for(r)

            m = alive.size
            if queries is None and m == q_total:
                # whole-cloud self round: the resident device buffer IS the
                # query block — no host gather, no re-upload
                self._c["query_upload_skips"] += 1
                q, qid = self._pts_t, qid_all
            else:
                q, qid = q_all[alive], qid_all[alive]
            d2, idx, found, tests = fixed_radius_round(
                self._pts_t, grid, q, qid, r, k, chunk=self._chunk,
            )
            self._c["dispatches"] += 1
            d2 = d2.cpu().numpy()
            idx = idx.cpu().numpy()
            found = found.cpu().numpy()
            total_tests += int(tests)

            resolved = found >= k
            done_ids = alive[resolved]
            out_d[done_ids] = np.sqrt(d2[resolved])
            out_i[done_ids] = idx[resolved]
            found_all[done_ids] = found[resolved]
            resolved_at[done_ids] = r
            # unresolved queries keep their best-so-far partial lists: this
            # is what the stop_radius tail hands back (paper Sec. 5.5.1 —
            # "however many neighbors they found")
            tail_ids = alive[~resolved]
            out_d[tail_ids] = np.sqrt(d2[~resolved])
            out_i[tail_ids] = idx[~resolved]
            found_all[tail_ids] = found[~resolved]
            alive = tail_ids

            dt = time.perf_counter() - t0
            rounds.append(
                RoundStats(ridx, r, m, int(resolved.sum()), int(tests),
                           grid.res, grid.cap, dt, cache_hit=hit)
            )
            ridx += 1

            if at_cap:
                # hybrid boundary round done: alive queries hold their
                # complete in-cap neighbor sets (found < k), by design
                break

            # Guard: a single-cell grid whose radius covers the cloud
            # diagonal makes the round a brute-force pass over all points.
            # If queries still failed to resolve, growing the radius cannot
            # help — fall through to the exact oracle instead of spinning.
            brute_equiv = all(res == 1 for res in grid.res) and (
                r * r >= self._sq_diag
            )
            if alive.size and brute_equiv:
                force_brute_tail = True
                break

            r *= self._growth
            # radius covering 4x the extent is always brute-equivalent;
            # growing past it only loses float precision
            if r > clamp_r and alive.size:
                r = clamp_r

        if alive.size and (force_brute_tail or stop_radius is None):
            # max_rounds exhausted or brute-equivalent round failed: finish
            # with the exact oracle (self-exclusion preserved via query ids).
            t0 = time.perf_counter()
            bd, bi, btests = brute_knn_engine(
                self._pts_t, k, queries=q_all[alive], query_ids=qid_all[alive]
            )
            self._c["dispatches"] += 1
            bd = bd.cpu().numpy()
            bi = bi.cpu().numpy()
            if cap_exact:
                # the tail is UNBOUNDED kNN; re-impose the hybrid cap so
                # neighbors beyond spec.radius are never reported (the
                # brute-equivalent guard can fire below the cap radius)
                from ..planner import apply_radius_cut

                bd, bi, bfound = apply_radius_cut(bd, bi, stop_radius, n)
                found_all[alive] = bfound
            else:
                # honest count: k in the usual case, fewer when k exceeds
                # the cloud (the engine inf-pads past N-1 real neighbors)
                found_all[alive] = np.isfinite(bd).sum(1)
            out_d[alive] = bd
            out_i[alive] = bi
            total_tests += int(btests)
            self._c["brute_tail_queries"] += int(alive.size)
            rounds.append(
                RoundStats(ridx, float("inf"), int(alive.size),
                           int(alive.size), int(btests), (), 0,
                           time.perf_counter() - t0)
            )
            alive = np.empty((0,), dtype=np.int64)

        p50 = self._update_warm(resolved_at)

        n_builds = sum(1 for rs in rounds if np.isfinite(rs.radius) and not rs.cache_hit)
        n_hits = sum(1 for rs in rounds if rs.cache_hit)
        self._c["batches"] += 1
        self._c["queries_served"] += q_total
        self._c["rounds"] += len(rounds)

        return KNNResult(
            dists=out_d,
            idxs=out_i,
            n_tests=total_tests,
            backend=self.backend_name,
            metric=metric_name,
            found=found_all,
            rounds=rounds,
            timings={
                "query_seconds": time.perf_counter() - t_call,
                "grid_builds": n_builds,
                "grid_cache_hits": n_hits,
                "start_radius_source": r_source,
                "warm_start_radius": r0 if r_source == "warm" else None,
                "resolved_radius_p50": p50,
                **self._since(mark),
            },
            start_radius=r0,
            final_radius=rounds[-1].radius if rounds else r0,
        )

    def _marks(self) -> tuple:
        """(build seconds, probe passes, probe seconds) so far."""
        c = self._probe_cache
        return (self._build_s, int(c.get("_passes", 0)),
                float(c.get("_seconds", 0.0)))

    def _since(self, mark: tuple) -> dict:
        """The grid builds' host seconds (the ``_grid_for`` calls that
        built) and the sizing probes' passes and seconds since ``mark``, as
        timings."""
        now = self._marks()
        return {"grid_build_seconds": now[0] - mark[0],
                "grid_probe_passes": now[1] - mark[1],
                "grid_probe_seconds": now[2] - mark[2]}

    def _update_warm(self, resolved_at: np.ndarray) -> Optional[float]:
        """Warm-start update: EMA of a low percentile of the radii at which
        queries resolved (brute-tail queries carry no radius information).
        Returns the distribution's p50 for serving telemetry (host-side —
        no extra device sync)."""
        fin = resolved_at[np.isfinite(resolved_at)]
        if not fin.size:
            return None
        if self._warm_start:
            target = float(np.percentile(fin, self._warm_pct))
            if self._warm_r is None:
                self._warm_r = target
            else:
                self._warm_r = (
                    (1.0 - self._warm_ema) * self._warm_r
                    + self._warm_ema * target
                )
        return float(np.percentile(fin, 50.0))

    def _run_knn_fused(
        self,
        q_all: np.ndarray,
        qid_all: np.ndarray,
        k: int,
        r0: float,
        r_source: str,
        *,
        stop_radius: Optional[float],
        cap_exact: bool,
        metric_name: str,
        ctx,
        t_call: float,
    ) -> Optional[KNNResult]:
        """One-sync search: schedule on host, loop on device, then
        reconstruct the host loop's exact bookkeeping (rounds, warm EMA,
        counters) from the loop carry.  Returns None for schedules the
        device loop cannot improve (zero rounds) — the host loop handles
        those verbatim."""
        n = self.n_points
        q_total = q_all.shape[0]
        with span("repro_torch.trueknn.schedule"):
            sched = build_schedule(
                self, r0, stop_radius=stop_radius, cap_exact=cap_exact
            )
        if not sched.radii:
            return None
        q_in = q_all
        if q_all is self._pts:
            # self-batch: the resident device buffer doubles as the query
            # block — no host->device re-upload of the cloud
            q_in = self._pts_t
            self._c["query_upload_skips"] += 1
        fr = fused_search(
            self._pts_t, sched, q_in, qid_all, k, chunk=self._chunk
        )
        self._c["dispatches"] += 1

        with span("repro_torch.trueknn.finish"):
            out_d, out_i = fr.dists, fr.idxs
            found_all = fr.found.astype(np.int64)
            unres = fr.unresolved  # pre-tail mask
            rr = fr.resolved_round
            t_final = fr.n_executed
            n_tail = int(unres.sum())
            tail_ran = sched.tail_mode != "none" and n_tail > 0
            if tail_ran:
                # the device tail replaced unresolved rows with the exact
                # unbounded oracle answer; the hybrid re-cut and the found
                # recount are the same host-side post-filters the host loop
                # applies to its brute tail
                if cap_exact:
                    from ..planner import apply_radius_cut

                    bd, bi, bfound = apply_radius_cut(
                        out_d[unres], out_i[unres], stop_radius, n
                    )
                    out_d[unres] = bd
                    out_i[unres] = bi
                    found_all[unres] = bfound
                else:
                    found_all[unres] = np.isfinite(out_d[unres]).sum(1)
                self._c["brute_tail_queries"] += n_tail

            radii = np.asarray(sched.radii, np.float64)
            alive_forever = rr < 0
            rounds = []
            total_tests = 0
            for t in range(t_final):
                m = int(np.sum(alive_forever | (rr >= t)))
                n_res = int(np.sum(rr == t))
                tests_t = int(fr.tests[t])
                g = sched.grids[t]
                rounds.append(
                    RoundStats(t, float(radii[t]), m, n_res, tests_t,
                               g.res, g.cap, 0.0,
                               cache_hit=sched.cache_hits[t])
                )
                total_tests += tests_t
            if tail_ran:
                btests = n_tail * n
                rounds.append(
                    RoundStats(t_final, float("inf"), n_tail, n_tail, btests,
                               (), 0, 0.0)
                )
                total_tests += btests

            resolved_at = np.where(
                rr >= 0, radii[np.clip(rr, 0, len(radii) - 1)], np.nan
            )
            p50 = self._update_warm(resolved_at)

            n_builds = sum(
                1 for rs in rounds
                if np.isfinite(rs.radius) and not rs.cache_hit
            )
            n_hits = sum(1 for rs in rounds if rs.cache_hit)
            self._c["batches"] += 1
            self._c["queries_served"] += q_total
            self._c["rounds"] += len(rounds)

            if ctx is not None and getattr(ctx, "canonical_shapes", False):
                ctx.record_bucket(
                    ("fused", "hybrid" if cap_exact else "knn", k, fr.q_pad,
                     sched.signature())
                )

            return KNNResult(
                dists=out_d,
                idxs=out_i,
                n_tests=total_tests,
                backend=self.backend_name,
                metric=metric_name,
                found=found_all,
                rounds=rounds,
                timings={
                    "query_seconds": time.perf_counter() - t_call,
                    "grid_builds": n_builds,
                    "grid_cache_hits": n_hits,
                    "start_radius_source": r_source,
                    "warm_start_radius": r0 if r_source == "warm" else None,
                    "plan": f"fused/rounds<={len(sched.radii)}",
                    "rounds_launched": len(sched.radii),
                    "fused_dispatches": 1,
                    "resolved_radius_p50": p50,
                },
                start_radius=r0,
                final_radius=rounds[-1].radius if rounds else r0,
            )

    def stats(self) -> dict:
        s = super().stats()
        s.update(self._c)
        s["cached_grids"] = len(self._grids)
        s["warm_radius"] = self._warm_r
        s["fused"] = self._fused
        s["grid_probe_hits"] = int(self._probe_cache.get("_hits", 0))
        s["grid_probe_misses"] = int(self._probe_cache.get("_misses", 0))
        s["grid_probe_passes"] = int(self._probe_cache.get("_passes", 0))
        s["grid_probe_seconds"] = float(self._probe_cache.get("_seconds", 0.0))
        return s
