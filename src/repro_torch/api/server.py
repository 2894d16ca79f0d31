"""NeighborServer: an async microbatching serving front-end for resident
indexes (port of ``repro.api.server``).

The paper's build-once/iterate design (the BVH is built once, rounds only
re-search unresolved queries) rewards exactly one serving shape: a resident
``NeighborIndex`` behind a request queue.  RTNN's scheduling results add
the second half of the story — *how* queries are grouped into batches is a
first-order performance knob, so grouping must live server-side where the
whole queue is visible, not per call site.

``NeighborServer`` is a *multi-tenant* front-end: a named registry of
resident ``NeighborIndex`` instances behind one queue fabric.  Per tenant
and request it provides:

* **Tickets.**  ``submit(rows, spec, metric=..., index=...)`` enqueues a
  request against the named resident index and returns a :class:`Ticket`
  future immediately; ``ticket.result()`` blocks (driving the queue itself
  when no worker thread is running, so single-threaded callers never
  deadlock), ``ticket.done()`` polls.
* **Microbatching.**  Pending requests are coalesced into one padded batch
  per (index, spec, metric) queue — only *identical* specs against the
  same tenant merge, so results are exactly what ``index.query`` would
  return — and the padded row count is rounded up to a power of two so the
  plans and kernel launches underneath see a handful of shapes, not one
  per arrival pattern.  The shape bucket is therefore (index, spec kind,
  k, metric, padded Q): many clients, one plan per tenant.
* **Batch reordering.**  Inside each coalesced batch, queries are
  Morton-sorted before padding and unsorted on completion
  (``reorder="morton"``, the default; ``"none"`` disables) — RTNN's
  observation that spatially coherent batches retire together, applied at
  the one place that sees whole batches.  Row order never affects answers
  (rows are independent), only locality; ``stats()`` counts
  ``reordered_batches`` so the knob's engagement is observable.
* **Admission control.**  ``max_queue=N`` bounds pending rows: a submit
  that would exceed it fails *fast* — the ticket comes back already done
  and ``result()`` raises :class:`AdmissionError` — instead of growing the
  queue without bound (load shedding at the front door, not deep in the
  stack).  ``stats()["rejected"]`` counts shed requests.
* **Result cache.**  An LRU keyed on (index, spec, metric, quantized query
  coordinates) serves repeat queries without touching the index.  Keys
  quantize each coordinate to ``cache_quant`` (default 1e-6): queries
  closer than the quantum collide and share an answer — set
  ``cache_size=0`` if even that is too much approximation.
* **Prepared plans.**  Every (index, spec, metric) bucket is served
  through a cached ``QueryPlan`` (``index.prepare``): route construction
  and the plan's shape buckets amortize across that tenant's batches.
  ``server.prepare(spec, index=...)`` builds one up front;
  ``server.active_plans()`` returns the structured plan trees; per-bucket
  ``stats()`` carry the plan-cache hit/miss counters.
* **Metering.**  Per (index, spec-kind, k, metric) bucket: request latency
  p50/p99, throughput, batch-size histogram, cache hit rate, plan-cache
  hit/miss, queue depth — all through ``server.stats()``.
* **Workloads.**  ``submit_graph(k)`` / ``submit_cluster(eps, min_pts)``
  enqueue whole-cloud batch analytics (kNN-graph construction, DBSCAN —
  see ``repro_torch.workloads``) as tickets on the same queue fabric: they
  order against the tenant's writes like reads do, run under the serve
  lock, and are metered per tenant under ``stats()["workloads"]``.

Synchronous use (tests, notebooks)::

    server = NeighborServer(index)           # registered as "default"
    t1 = server.submit(q1, KnnSpec(8))
    t2 = server.submit(q2, KnnSpec(8))      # same bucket: coalesces with t1
    res = t1.result()                        # drives the queue inline

Multi-tenant open-loop use (real serving)::

    server = NeighborServer(indexes={"lidar": idx_a, "gps": idx_b},
                            max_queue=50_000)
    server.start()                           # background worker thread
    tickets = [server.submit(q, spec, index="lidar") for q in arrivals]
    outs = [t.result(timeout=30) for t in tickets]
    server.stop()

This module also owns two small serving-loop helpers shared by
``launch/serve.py`` and the benchmarks: :func:`warm_default_radius` (the
finite-median default radius) and :func:`dropped_counts` (per-query, not
per-cell, drop counting).

The module is host code (numpy, ``threading``); the tenants' indexes do
the device work.  Every plan execution, write and workload runs inside a
device scope: the tenant's device is the thread's current CUDA device,
and in worker-thread mode the stream current on that device when
:meth:`NeighborServer.start` was called is the worker's, so the worker's
torch ops land where a direct ``index.query`` from the starting thread
would.  ``start()`` builds the kernels before it spawns the worker when a
tenant lives on the card, so no build ever starts inside it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from .._device import device_scope
from ..core.grid import _next_pow2
from ..core.partition import morton_codes
from ..core.result import KNNResult, RangeResult
from .query import QuerySpec

__all__ = [
    "NeighborServer",
    "Ticket",
    "AdmissionError",
    "warm_default_radius",
    "dropped_counts",
    "poisson_open_loop",
]

DEFAULT_INDEX = "default"


class _WriteSpec:
    """Queue-key marker for write tickets (inserts/deletes).

    Writes ride the same per-tenant queue fabric as reads — the key
    ``(index_name, _WRITE, "-")`` is one more bucket, so ``_pick_queue``'s
    oldest-head FIFO interleaves write batches with read batches in
    arrival order, and all writes to a tenant share one queue (their
    mutual order is preserved exactly).  Duck-types the two spec
    attributes the meters read."""

    kind = "write"
    k = None

    def __repr__(self):
        return "<write>"


_WRITE = _WriteSpec()


class _WorkloadSpec:
    """Queue-key marker for graph-workload tickets (kNN-graph builds,
    DBSCAN runs).  One instance per submitted workload — each is its own
    queue bucket, workloads never coalesce — but, not being a
    ``_WriteSpec``, they sit on the *read* side of ``step()``'s
    write/read barrier: a workload snapshots the tenant strictly between
    the writes submitted before and after it.  Duck-types the spec
    attributes the meters read (``kind``, ``k``)."""

    __slots__ = ("kind", "k", "eps", "min_pts", "symmetrize")

    def __init__(self, kind, *, k=None, eps=None, min_pts=None,
                 symmetrize=None):
        self.kind = kind
        self.k = k
        self.eps = eps
        self.min_pts = min_pts
        self.symmetrize = symmetrize

    def __repr__(self):
        if self.kind == "graph":
            return f"<graph k={self.k} symmetrize={self.symmetrize}>"
        return f"<cluster eps={self.eps} min_pts={self.min_pts}>"


class AdmissionError(RuntimeError):
    """A submit was shed by admission control (``max_queue`` exceeded)."""


# -- serving-loop helpers ----------------------------------------------------


def warm_default_radius(warm_dists, index=None) -> float:
    """Default serving radius from a warm batch: the median *finite*
    k-th-NN distance.

    ``np.median(warm_dists[:, -1])`` is the natural default — a radius most
    queries can fill — but it breaks the moment any warm query fails to
    fill k neighbors (stop_radius tails, radius-bounded backends): the
    last column holds ``inf``, and one inf row is enough to push the
    median to inf or propagate NaN into specs.  This helper medians over
    the finite entries only, and when *none* are finite falls back to the
    index's sampled start radius (paper Alg. 2), which depends only on the
    resident cloud: the index's own ``_sampled_r`` when it has one, else a
    fresh sample searched on the index's device.
    """
    last = np.asarray(warm_dists)[:, -1].astype(np.float64)
    fin = last[np.isfinite(last)]
    if fin.size:
        return float(np.median(fin))
    if index is None:
        raise ValueError(
            "no warm query filled k neighbors and no index was given to "
            "fall back to its sampled radius"
        )
    r = getattr(index, "_sampled_r", None)
    if r is None:
        from ..core.sampling import sample_start_radius

        with device_scope(index.device):
            r = sample_start_radius(_resident_points(index))
    return float(r)


def _resident_points(index) -> torch.Tensor:
    """The index's live cloud as a tensor on its device: the resident
    tensor where it holds the live cloud, else the live rows moved
    there (a mutable index materializes them per call)."""
    pts = index.points
    resident = getattr(index, "_pts_t", None)
    if resident is not None and pts is getattr(index, "_pts", None):
        return resident
    return torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(
        index.device)


def dropped_counts(dists) -> tuple:
    """(queries with *any* inf slot, queries with *all* slots inf).

    ``np.isinf(dists).sum()`` counts inf *cells* and overstates drops by up
    to k x (one unresolved query contributes up to k).  Serving reports
    want queries: ``any`` counts partially-filled rows, ``all`` counts
    queries that found nothing.
    """
    inf = np.isinf(np.asarray(dists))
    if inf.ndim == 1:
        inf = inf[:, None]
    return int(inf.any(axis=1).sum()), int(inf.all(axis=1).sum())


def poisson_open_loop(server, rows, spec, rate, rng, *, metric="l2",
                      index=None, timeout=120.0):
    """Drive ``server`` with a Poisson open-loop arrival process: one
    request per row of ``rows``, exponential inter-arrival gaps at ``rate``
    requests/second, submitted regardless of completions (the regime where
    microbatching earns its keep).  Starts the worker thread, waits for
    every ticket, stops the worker.

    Returns ``(results, wall_seconds, latencies)`` with ``latencies`` the
    per-request submit-to-done seconds.  Requests shed by admission
    control (``max_queue``) are *expected* under overload — this is the
    regime load shedding exists for — so they are dropped from
    ``results`` rather than crashing the drive; the shed count is on
    ``server.stats()["rejected"]``.  Shared by ``launch/serve.py
    --arrival open`` and ``benchmarks/bench_serve.py`` so both measure the
    same arrival process.
    """
    rows = np.asarray(rows, np.float32)
    targets = np.cumsum(rng.exponential(1.0 / rate, size=len(rows)))
    server.start()
    t0 = time.perf_counter()
    try:
        tickets = []
        for i in range(len(rows)):
            delay = t0 + float(targets[i]) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tickets.append(
                server.submit(rows[i], spec, metric=metric, index=index)
            )
        results = []
        for t in tickets:
            try:
                results.append(t.result(timeout=timeout))
            except AdmissionError:
                pass  # shed by load control; counted in stats()["rejected"]
        wall = time.perf_counter() - t0
    finally:
        # a timeout/failure must not leak the worker thread: a leaked
        # worker keeps calling index.query under later callers of the
        # same index
        server.stop()
    lat = np.asarray(
        [r.timings["request_seconds"] for r in results], np.float64
    )
    return results, wall, lat


# -- tickets -----------------------------------------------------------------


class Ticket:
    """Future for one submitted request.

    ``result()`` returns the same type ``index.query`` would have returned
    for this request's rows alone (``KNNResult`` for knn/hybrid,
    ``RangeResult`` for range).  When no worker thread is running, the
    calling thread drives the server's queue itself, so tickets always
    make progress.
    """

    __slots__ = (
        "_server", "spec", "metric", "index_name", "n_rows", "submitted_at",
        "_event", "_result", "_error", "_rows_left", "_asm",
    )

    def __init__(self, server, spec, metric, n_rows, index_name=DEFAULT_INDEX):
        self._server = server
        self.spec = spec
        self.metric = metric
        self.index_name = index_name
        self.n_rows = n_rows
        self.submitted_at = time.perf_counter()
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._rows_left = n_rows
        self._asm: dict = {"rows": [None] * n_rows, "cache_hits": 0,
                           "n_tests": 0, "batch_sizes": []}

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until served; drives the queue inline when the server has
        no worker thread."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self._event.is_set():
            if self._server._worker_alive():
                # bounded slices, not one open-ended wait: if the worker is
                # stopped without draining while we sleep, the next loop
                # iteration sees it gone and self-drives the queue instead
                # of blocking forever
                remaining = (
                    None if deadline is None
                    else max(0.0, deadline - time.perf_counter())
                )
                slice_s = 0.05 if remaining is None else min(0.05, remaining)
                if not self._event.wait(slice_s) and remaining is not None \
                        and remaining <= slice_s:
                    raise TimeoutError(
                        f"ticket not served within {timeout}s "
                        f"(spec={self.spec}, queue={self._server._depth()})"
                    )
            else:
                served = self._server.step()
                if served == 0 and not self._event.is_set():
                    # another polling thread holds the rows of our batch;
                    # yield until it finalizes us
                    self._event.wait(0.01)
            if deadline is not None and time.perf_counter() > deadline:
                if not self._event.is_set():
                    raise TimeoutError(f"ticket not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


# -- per-bucket metering -----------------------------------------------------


class _Meter:
    """Counters for one (index, spec-kind, k, metric) serving bucket.

    All state is O(1) in served traffic: counts, a streaming batch-size
    histogram, and a bounded sliding window of recent request latencies
    (``LATENCY_WINDOW``) — a long-running worker must not grow memory per
    request, and the recent window is what serving percentiles mean
    anyway."""

    LATENCY_WINDOW = 4096

    __slots__ = ("requests", "rows", "batches", "batch_rows", "batch_hist",
                 "latencies", "cache_hits", "cache_misses", "rejected",
                 "reordered_batches", "resolved_radii")

    def __init__(self):
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batch_rows = 0
        self.batch_hist: dict = {}
        self.latencies: deque = deque(maxlen=self.LATENCY_WINDOW)
        self.cache_hits = 0
        self.cache_misses = 0
        self.rejected = 0
        self.reordered_batches = 0
        # per-batch median resolved radii from the fused round loop's
        # carry — already on the host in the result timings, so tracking
        # them costs no extra device sync
        self.resolved_radii: deque = deque(maxlen=self.LATENCY_WINDOW)

    def record_batch(self, n_rows: int, *, reordered: bool = False,
                     resolved_radius_p50=None) -> None:
        self.batches += 1
        self.batch_rows += n_rows
        self.batch_hist[int(n_rows)] = self.batch_hist.get(int(n_rows), 0) + 1
        if reordered:
            self.reordered_batches += 1
        if resolved_radius_p50 is not None:
            self.resolved_radii.append(float(resolved_radius_p50))

    def summary(self, queue_depth: int) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        looked = self.cache_hits + self.cache_misses
        return {
            "requests": self.requests,
            "rows": self.rows,
            "batches": self.batches,
            "batch_size_hist": dict(self.batch_hist),
            "mean_batch_rows": (
                round(self.batch_rows / self.batches, 2) if self.batches else 0.0
            ),
            "latency_p50_ms": (
                round(float(np.percentile(lat, 50)) * 1e3, 3) if lat.size else None
            ),
            "latency_p99_ms": (
                round(float(np.percentile(lat, 99)) * 1e3, 3) if lat.size else None
            ),
            "cache_hits": self.cache_hits,
            "cache_hit_rate": (
                round(self.cache_hits / looked, 4) if looked else 0.0
            ),
            "rejected": self.rejected,
            "reordered_batches": self.reordered_batches,
            "resolved_radius_p50": (
                round(float(np.percentile(
                    np.asarray(self.resolved_radii, np.float64), 50
                )), 6)
                if self.resolved_radii
                else None
            ),
            "queue_depth": queue_depth,
        }


# -- the server --------------------------------------------------------------


class NeighborServer:
    """Microbatching request front-end over named resident indexes.

    Args:
      index: convenience single tenant, registered under the name
        ``"default"`` (the server owns each tenant's hot path — don't call
        ``index.query`` concurrently from elsewhere).
      indexes: dict of name -> ``NeighborIndex`` tenants; combines with
        ``index``.  More tenants can join later via :meth:`add_index`.
      max_batch: most query rows coalesced into one ``index.query`` call.
      cache_size: LRU capacity in cached *rows* (0 disables the cache).
      cache_quant: coordinate quantum of the cache key; queries closer
        than this per-axis collide onto one cached answer.
      pad_pow2: round each batch's row count up to a power of two (with
        duplicated rows) so plans see few shapes.  Padding rows are real
        queries to the fronted index — they never appear in served
        results or the server's own meters, but the *index's* counters
        (``queries_served``, warm-start state) do include them; compare
        server meters, not ``stats()["indexes"]``, when reconciling
        request counts.  Set False to trade shape churn for exact index
        counters.
      max_wait_ms: how long the worker thread idles waiting for arrivals
        before re-checking (worker mode only; no artificial batching
        delay is ever added — a batch forms from whatever is pending).
      max_queue: admission bound on *pending rows* across all tenants; a
        submit that would exceed it comes back as an already-failed
        ticket raising :class:`AdmissionError` (None = unbounded).
      reorder: "morton" Z-order-sorts each coalesced batch's rows before
        padding and unsorts on completion (RTNN batch scheduling; answers
        are row-independent so results are unchanged); "none" disables.
    """

    def __init__(
        self,
        index=None,
        *,
        indexes: Optional[dict] = None,
        max_batch: int = 512,
        cache_size: int = 4096,
        cache_quant: float = 1e-6,
        pad_pow2: bool = True,
        max_wait_ms: float = 2.0,
        max_queue: Optional[int] = None,
        reorder: str = "morton",
    ):
        if reorder not in ("morton", "none"):
            raise ValueError(
                f"reorder must be 'morton' or 'none', got {reorder!r}"
            )
        self._indexes: "OrderedDict[str, object]" = OrderedDict()
        if index is not None:
            self._indexes[DEFAULT_INDEX] = index
        for name, idx in (indexes or {}).items():
            self._indexes[str(name)] = idx
        if not self._indexes:
            raise ValueError(
                "NeighborServer needs at least one resident index "
                "(positional `index` and/or the `indexes` dict)"
            )
        self.max_batch = int(max_batch)
        self.cache_size = int(cache_size)
        self.cache_quant = float(cache_quant)
        self.pad_pow2 = bool(pad_pow2)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.reorder = reorder

        self._lock = threading.RLock()
        self._serve_lock = threading.Lock()  # serializes index.query calls
        self._arrived = threading.Condition(self._lock)
        # (index_name, spec, metric) -> deque of (ticket, local_row, row)
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._meters: dict = {}  # (index_name, kind, k, metric) -> _Meter
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # (index_name, spec, metric) -> prepared QueryPlan: batches are
        # served through prepared plans, so route construction and the
        # plan's shape buckets amortize per tenant bucket.
        # LRU-bounded (MAX_PLANS): clients deriving a fresh radius per
        # request mint unbounded distinct specs, and each plan holds a
        # route tree + counters that must not accumulate forever.
        self._plans: "OrderedDict[tuple, object]" = OrderedDict()
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        self._submitted = 0
        self._served = 0
        self._rejected = 0
        self._inflight: dict = {}  # index_name -> rows popped, not yet served
        # index_name -> {"inserts": rows, "deletes": rows, "write_ops": n}
        self._tenant_writes: dict = {}
        # index_name -> {"graphs": n, "clusters": n, "workload_rows": rows}
        self._tenant_workloads: dict = {}
        # CUDA device -> the stream current there when start() ran; the
        # worker runs its torch ops on it
        self._streams: dict = {}

    # -- tenant registry ---------------------------------------------------

    @property
    def index(self):
        """The sole/default tenant (back-compat for single-index use).
        Raises ``ValueError`` (never AttributeError, which ``hasattr`` /
        ``getattr``-with-default would silently swallow) when several
        named tenants make the bare handle ambiguous."""
        return self._indexes[self._resolve_index(None)]

    def indexes(self) -> list:
        return sorted(self._indexes)

    def add_index(self, name: str, index) -> None:
        """Register a resident index under ``name`` (rejects live names —
        swapping a tenant under in-flight tickets would serve them from
        the wrong cloud)."""
        name = str(name)
        with self._lock:
            if name in self._indexes:
                raise ValueError(f"index {name!r} is already registered")
            if self._worker_alive():
                self._ready_devices([index])
            self._indexes[name] = index

    def remove_index(self, name: str):
        """Deregister and return tenant ``name``; refuses while requests
        for it are pending — queued *or* popped into a batch the worker is
        serving right now (yanking the index mid-batch would strand those
        tickets)."""
        name = str(name)
        with self._lock:
            if name not in self._indexes:
                raise KeyError(name)
            pending = sum(
                len(q) for (iname, _, _), q in self._queues.items()
                if iname == name
            ) + self._inflight.get(name, 0)
            if pending:
                raise ValueError(
                    f"index {name!r} has {pending} pending rows; drain first"
                )
            for key in [k for k in self._plans if k[0] == name]:
                del self._plans[key]
            return self._indexes.pop(name)

    def _resolve_index(self, name: Optional[str]) -> str:
        if name is None:
            if DEFAULT_INDEX in self._indexes:
                return DEFAULT_INDEX
            if len(self._indexes) == 1:
                return next(iter(self._indexes))
            raise ValueError(
                f"server fronts several indexes ({sorted(self._indexes)}); "
                "pass submit(..., index=name)"
            )
        name = str(name)
        if name not in self._indexes:
            raise KeyError(
                f"unknown index {name!r}; registered: {sorted(self._indexes)}"
            )
        return name

    # -- public API --------------------------------------------------------

    def submit(
        self,
        queries,
        spec: QuerySpec,
        *,
        metric: str = "l2",
        index: Optional[str] = None,
    ) -> Ticket:
        """Enqueue ``queries`` ((d,) or (Q, d)) under ``spec`` against the
        named resident ``index`` (the default tenant when omitted);
        returns a :class:`Ticket` immediately.  Rows already in the cache
        are served on the spot; the rest wait for a batch.  When admission
        control is on and the queue is full, the ticket comes back already
        failed with :class:`AdmissionError`."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(
                f"spec must be a QuerySpec, got {type(spec).__name__}"
            )
        spec.validate()
        name = self._resolve_index(index)
        target = self._indexes[name]
        rows = np.asarray(queries, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != target.dim:
            raise ValueError(
                f"queries must be (Q, {target.dim}) or "
                f"({target.dim},) for index {name!r}, got {rows.shape}"
            )
        if rows.shape[0] == 0:
            raise ValueError("cannot submit an empty query batch")
        ticket = Ticket(self, spec, metric, rows.shape[0], index_name=name)
        with self._lock:
            if name not in self._indexes:
                # the tenant was remove_index'd between resolution and
                # here; enqueuing now would strand the rows past the
                # remover's no-pending guarantee (and a meter created
                # before this check would leak a phantom bucket)
                raise KeyError(
                    f"unknown index {name!r}; registered: "
                    f"{sorted(self._indexes)}"
                )
            meter = self._meter(name, spec, metric)
            # cache first, admission second: only the rows that would
            # actually *enqueue* count against max_queue, so a fully
            # cached repeat query is never shed by a full queue (hot
            # queries are the last traffic load shedding should drop)
            hits = [
                self._cache_get(name, spec, metric, rows[li])
                for li in range(rows.shape[0])
            ]
            n_miss = sum(1 for h in hits if h is None)
            # "pending" = queued + popped-but-unserved, same accounting
            # remove_index uses — a slow in-flight batch must not open
            # the admission gate to another max_batch of rows
            pending = self._depth() + sum(self._inflight.values())
            if (
                self.max_queue is not None
                and pending + n_miss > self.max_queue
            ):
                self._rejected += 1
                meter.rejected += 1
                ticket._error = AdmissionError(
                    f"queue full: {pending} rows pending, "
                    f"{n_miss} offered, max_queue={self.max_queue}"
                )
                ticket._event.set()
                return ticket
            self._submitted += 1
            meter.requests += 1
            meter.rows += rows.shape[0]
            queue = self._queues.setdefault((name, spec, metric), deque())
            for li, hit in enumerate(hits):
                if hit is not None:
                    meter.cache_hits += 1
                    ticket._asm["cache_hits"] += 1
                    self._fill_row(ticket, li, hit)
                else:
                    meter.cache_misses += 1
                    queue.append((ticket, li, rows[li]))
            if ticket._rows_left == 0:
                self._finalize(ticket, plan="cache")
            self._arrived.notify_all()
        return ticket

    def submit_insert(self, rows, *, index: Optional[str] = None) -> Ticket:
        """Enqueue an insert of ``rows`` ((d,) or (m, d)) against the
        named resident index; returns a :class:`Ticket` whose ``result()``
        is the minted stable ids ((m,) int64).  Writes share the tenant's
        queue fabric, so they interleave with reads in arrival order —
        every read submitted after this write's turn sees its effect.
        They are exempt from ``max_queue`` shedding (dropping a write
        loses data, dropping a read loses latency) but still count as
        pending rows, so a write backlog applies backpressure to reads.
        The tenant must be a mutable index (``backend="mutable"`` or
        ``make_mutable``); immutable tenants fail the ticket with
        ``NotImplementedError`` at apply time."""
        name = self._resolve_index(index)
        target = self._indexes[name]
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != target.dim:
            raise ValueError(
                f"insert rows must be (m, {target.dim}) or "
                f"({target.dim},) for index {name!r}, got {rows.shape}"
            )
        if rows.shape[0] == 0:
            raise ValueError("cannot submit an empty insert")
        return self._submit_write(name, ("insert", rows), rows.shape[0])

    def submit_delete(self, ids, *, index: Optional[str] = None) -> Ticket:
        """Enqueue a delete of stable ``ids`` against the named resident
        index; ``result()`` is the number of rows deleted.  Unknown or
        already-deleted ids fail the ticket with ``KeyError``.  Same
        queue/ordering/backpressure semantics as :meth:`submit_insert`."""
        name = self._resolve_index(index)
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            raise ValueError("cannot submit an empty delete")
        return self._submit_write(name, ("delete", ids), int(ids.size))

    def _submit_write(self, name, op, n_rows: int) -> Ticket:
        ticket = Ticket(self, _WRITE, "-", 1, index_name=name)
        with self._lock:
            if name not in self._indexes:
                raise KeyError(
                    f"unknown index {name!r}; registered: "
                    f"{sorted(self._indexes)}"
                )
            meter = self._meter(name, _WRITE, "-")
            meter.requests += 1
            meter.rows += n_rows
            self._submitted += 1
            queue = self._queues.setdefault((name, _WRITE, "-"), deque())
            queue.append((ticket, op, None))
            self._arrived.notify_all()
        return ticket

    def submit_graph(self, k, *, symmetrize: str = "union",
                     metric: str = "l2", chunk_rows=None,
                     index: Optional[str] = None) -> Ticket:
        """Enqueue a kNN-graph build over the named tenant's resident
        cloud; ``result()`` is a ``repro_torch.workloads.KnnGraph``.
        Workloads ride the tenant's queue fabric on the read side of the
        write barrier, so the graph snapshots the cloud exactly between the
        writes submitted before and after it.  Exempt from ``max_queue``
        shedding (one queued workload is one pending row, and dropping a
        batch analytic a client will simply resubmit saves nothing)."""
        from ..workloads.graph import _SYMMETRIZE_MODES

        name = self._resolve_index(index)
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if symmetrize not in _SYMMETRIZE_MODES:
            raise ValueError(
                f"symmetrize must be one of {_SYMMETRIZE_MODES}, "
                f"got {symmetrize!r}"
            )
        spec = _WorkloadSpec("graph", k=k, symmetrize=str(symmetrize))
        op = ("graph", {"k": k, "symmetrize": str(symmetrize),
                        "metric": metric, "chunk_rows": chunk_rows})
        return self._submit_workload(name, spec, metric, op)

    def submit_cluster(self, eps, min_pts, *, metric: str = "l2",
                       chunk_rows=None,
                       index: Optional[str] = None) -> Ticket:
        """Enqueue a DBSCAN(eps, min_pts) run over the named tenant's
        resident cloud; ``result()`` is a
        ``repro_torch.workloads.DbscanResult``.
        Same ordering/admission semantics as :meth:`submit_graph`."""
        name = self._resolve_index(index)
        eps = float(eps)
        min_pts = int(min_pts)
        if not (eps > 0.0):
            raise ValueError(f"eps must be > 0, got {eps}")
        if min_pts < 1:
            raise ValueError(f"min_pts must be >= 1, got {min_pts}")
        spec = _WorkloadSpec("cluster", eps=eps, min_pts=min_pts)
        op = ("cluster", {"eps": eps, "min_pts": min_pts,
                          "metric": metric, "chunk_rows": chunk_rows})
        return self._submit_workload(name, spec, metric, op)

    def _submit_workload(self, name, spec, metric, op) -> Ticket:
        ticket = Ticket(self, spec, metric, 1, index_name=name)
        with self._lock:
            if name not in self._indexes:
                raise KeyError(
                    f"unknown index {name!r}; registered: "
                    f"{sorted(self._indexes)}"
                )
            meter = self._meter(name, spec, metric)
            meter.requests += 1
            meter.rows += 1
            self._submitted += 1
            queue = self._queues.setdefault((name, spec, metric), deque())
            queue.append((ticket, op, None))
            self._arrived.notify_all()
        return ticket

    def step(self) -> int:
        """Serve one microbatch from the (index, spec, metric) queue whose
        head request has waited longest (FIFO across buckets — no
        starvation).  Returns the number of query rows served (write
        tickets count one row each; 0 = nothing pending).  This is the
        whole serving engine; the worker thread just loops it.
        """
        with self._lock:
            key, queue = self._pick_queue()
            if key is None:
                return 0
            name, spec, metric = key
            is_write = isinstance(spec, _WriteSpec)
            # Writes do not commute with reads: a read batch may coalesce
            # only requests that arrived before the tenant's oldest pending
            # write (and a write batch only ops older than its oldest
            # pending read), so conflicting operations on a tenant are
            # served in arrival order while read/read coalescing across a
            # bucket stays unrestricted.  The popped head itself is the
            # globally oldest request, so the batch is never empty.
            barrier = float("inf")
            for (nm, sp, _me), q in self._queues.items():
                if nm == name and q and isinstance(sp, _WriteSpec) != is_write:
                    barrier = min(barrier, q[0][0].submitted_at)
            batch = []
            while queue and len(batch) < self.max_batch and (
                not batch or queue[0][0].submitted_at < barrier
            ):
                batch.append(queue.popleft())
            if not queue:
                self._queues.pop(key, None)
            # popped rows stay "pending" for remove_index until served
            self._inflight[name] = self._inflight.get(name, 0) + len(batch)
        try:
            if isinstance(spec, _WriteSpec):
                return self._run_writes(name, batch)
            if isinstance(spec, _WorkloadSpec):
                return self._run_workloads(name, batch)
            return self._run_batch(name, spec, metric, batch)
        finally:
            with self._lock:
                left = self._inflight.get(name, 0) - len(batch)
                if left > 0:
                    self._inflight[name] = left
                else:
                    self._inflight.pop(name, None)

    def drain(self) -> int:
        """Serve until every pending row is answered; returns rows served."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                return total
            total += n

    def start(self) -> None:
        """Spawn the background worker thread (idempotent).  Builds the
        kernels first when a tenant lives on the card, and records the
        calling thread's current stream on each tenant's card for the
        worker."""
        with self._lock:
            if self._worker_alive():
                return
            self._ready_devices(self._indexes.values())
            self._stop = False
            self._worker = threading.Thread(
                target=self._worker_loop, name="NeighborServer", daemon=True
            )
            self._worker.start()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the worker thread; by default serves what is pending first."""
        with self._lock:
            worker = self._worker
            self._stop = True
            self._arrived.notify_all()
        if worker is not None:
            worker.join()
        with self._lock:
            self._worker = None
            self._streams.clear()
        if drain:
            self.drain()

    def stats(self) -> dict:
        """Serving counters: totals, cache, per-(tenant, bucket)
        latency/throughput meters, and every resident index's own
        ``stats()`` under ``"indexes"``."""
        with self._lock:
            buckets = {}
            for (name, kind, k, metric), m in self._meters.items():
                summary = m.summary(
                    self._bucket_depth(name, kind, k, metric)
                )
                # executable-cache counters of the prepared plans serving
                # this bucket (plans are keyed by full spec; a meter bucket
                # aggregates every spec with the same kind/k/metric)
                plans = [
                    p for (nm, sp, me), p in self._plans.items()
                    if nm == name and sp.kind == kind
                    and getattr(sp, "k", None) == k and me == metric
                ]
                hits = sum(p.cache_stats()["hits"] for p in plans)
                misses = sum(p.cache_stats()["misses"] for p in plans)
                summary["plan_cache"] = {
                    "plans": len(plans),
                    "executable_buckets": sum(
                        p.cache_stats()["buckets"] for p in plans
                    ),
                    "hits": hits,
                    "misses": misses,
                    "hit_rate": (
                        round(hits / (hits + misses), 4)
                        if (hits + misses) else 0.0
                    ),
                    "invalidations": sum(
                        p.cache_stats()["invalidations"] for p in plans
                    ),
                }
                buckets[f"{name}/{kind}/k={k}/{metric}"] = summary
            hits = sum(m.cache_hits for m in self._meters.values())
            misses = sum(m.cache_misses for m in self._meters.values())
            plan_hits = plan_misses = plan_inval = n_plans = 0
            for p in self._plans.values():
                cs = p.cache_stats()
                plan_hits += cs["hits"]
                plan_misses += cs["misses"]
                plan_inval += cs["invalidations"]
                n_plans += 1
            return {
                "submitted": self._submitted,
                "served": self._served,
                "rejected": self._rejected,
                "reordered_batches": sum(
                    m.reordered_batches for m in self._meters.values()
                ),
                # same "pending" admission control and remove_index use:
                # queued plus popped-but-unserved, so a rejection message
                # always reconciles with these numbers
                "pending_rows": self._depth() + sum(self._inflight.values()),
                "inflight_rows": sum(self._inflight.values()),
                "worker_running": self._worker_alive(),
                "cache": {
                    "rows": len(self._cache),
                    "capacity": self.cache_size,
                    "hits": hits,
                    "misses": misses,
                    "hit_rate": (
                        round(hits / (hits + misses), 4)
                        if (hits + misses) else 0.0
                    ),
                },
                "plan_cache": {
                    "plans": n_plans,
                    "hits": plan_hits,
                    "misses": plan_misses,
                    "hit_rate": (
                        round(plan_hits / (plan_hits + plan_misses), 4)
                        if (plan_hits + plan_misses) else 0.0
                    ),
                    "invalidations": plan_inval,
                },
                "writes": {
                    name: dict(w) for name, w in self._tenant_writes.items()
                },
                "workloads": {
                    name: dict(w)
                    for name, w in self._tenant_workloads.items()
                },
                "buckets": buckets,
                "placement": self._placement_summary(),
                "indexes": {
                    name: idx.stats() for name, idx in self._indexes.items()
                },
            }

    def _placement_summary(self) -> dict:
        """Device-placement roll-up across tenants: per placed tenant the
        mesh occupancy and fused-dispatch/rebalance counters (from the
        sharded backend's ``stats()["placement"]`` section), plus fleet
        totals — the serving-side view of the one-dispatch-per-round
        fabric."""
        tenants = {}
        for name, idx in self._indexes.items():
            # both the sharded backend and the mutable composite (placed
            # base) surface the section through stats()
            ps = idx.stats().get("placement")
            if isinstance(ps, dict) and ps.get("mode") == "devices":
                tenants[name] = ps
        return {
            "tenants": tenants,
            "fused_dispatches": sum(
                t.get("fused_dispatches", 0) for t in tenants.values()
            ),
            "rebalances": sum(
                t.get("rebalances", 0) for t in tenants.values()
            ),
        }

    # -- prepared plans ----------------------------------------------------

    def prepare(self, spec: QuerySpec, *, metric: str = "l2",
                index: Optional[str] = None):
        """Prepare (and cache) the plan the server will serve ``spec``
        with against the named tenant; returns the ``QueryPlan``.  Batches
        for the same (index, spec, metric) bucket reuse it, so calling
        this up front moves plan construction out of the first request's
        latency.  ``plan.explain()`` shows the route."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(
                f"spec must be a QuerySpec, got {type(spec).__name__}"
            )
        spec.validate()
        return self._plan_for(self._resolve_index(index), spec, metric)

    def active_plans(self) -> dict:
        """index name -> list of structured plan trees (``explain()``) for
        every prepared (spec, metric) bucket currently cached."""
        with self._lock:
            out: dict = {}
            for (name, _spec, _metric), plan in self._plans.items():
                out.setdefault(name, []).append(plan.explain())
            return out

    #: LRU bound on cached prepared plans across all tenants
    MAX_PLANS = 256

    def _plan_for(self, name, spec, metric):
        key = (name, spec, metric)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                # canonical shapes follow pad_pow2: the server already pads
                # batches to pow2, so the plan's canonicalization is a
                # no-op on the hot path unless padding was disabled
                plan = self._indexes[name].prepare(
                    spec, metric=metric, canonical_shapes=self.pad_pow2
                )
                self._plans[key] = plan
                while len(self._plans) > self.MAX_PLANS:
                    self._plans.popitem(last=False)
            self._plans.move_to_end(key)
            return plan

    # -- internals ---------------------------------------------------------

    def _meter(self, name, spec, metric) -> _Meter:
        key = (name, spec.kind, getattr(spec, "k", None), metric)
        with self._lock:
            m = self._meters.get(key)
            if m is None:
                m = self._meters[key] = _Meter()
            return m

    def _bucket_depth(self, name, kind, k, metric) -> int:
        return sum(
            len(q)
            for (nm, sp, me), q in self._queues.items()
            if nm == name and sp.kind == kind
            and getattr(sp, "k", None) == k and me == metric
        )

    def _depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _ready_devices(self, indexes) -> None:
        """Build the kernels (once per process) and record the current
        stream of every card an index in ``indexes`` lives on."""
        for index in indexes:
            dev = getattr(index, "device", None)
            if dev is None or torch.device(dev).type != "cuda":
                continue
            from ..kernels.build import extension

            extension()
            self._streams.setdefault(dev, torch.cuda.current_stream(dev))

    def _scope(self, name):
        """Device scope of tenant ``name``'s work on this thread."""
        dev = getattr(self._indexes[name], "device", None)
        return device_scope(dev, self._streams.get(dev))

    def _worker_alive(self) -> bool:
        w = self._worker
        return w is not None and w.is_alive() and w is not threading.current_thread()

    def _pick_queue(self):
        """The queue whose head request has waited longest.  FIFO across
        buckets: every served batch removes the globally oldest pending
        request, so no bucket starves however lopsided the load — and the
        whole chosen queue still coalesces into the batch, so batching
        depth is unaffected where it matters (the busy bucket's head is
        usually also the oldest)."""
        best, best_t = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            t = q[0][0].submitted_at
            if best_t is None or t < best_t:
                best, best_t = key, t
        return (best, self._queues[best]) if best is not None else (None, None)

    def _worker_loop(self):
        while True:
            with self._lock:
                if self._stop:
                    return
                if self._depth() == 0:
                    self._arrived.wait(self.max_wait_ms / 1e3)
                    continue
            self.step()

    # cache ------------------------------------------------------------

    def _cache_key(self, name, spec, metric, row) -> tuple:
        q = np.round(np.asarray(row, np.float64) / self.cache_quant)
        return (name, spec, metric, q.astype(np.int64).tobytes())

    def _cache_get(self, name, spec, metric, row):
        if self.cache_size <= 0:
            return None
        key = self._cache_key(name, spec, metric, row)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, name, spec, metric, row, payload) -> None:
        if self.cache_size <= 0:
            return
        key = self._cache_key(name, spec, metric, row)
        self._cache[key] = payload
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    # write execution ---------------------------------------------------

    def _cache_purge(self, name: str) -> None:
        """Drop every cached result row of tenant ``name`` (caller holds
        the lock): a mutation may change any answer, and a stale hit
        would violate the read-your-writes ordering the write queue
        provides."""
        for key in [k for k in self._cache if k[0] == name]:
            del self._cache[key]

    def _run_writes(self, name, batch) -> int:
        """Apply one batch of write tickets in submission order.  Each op
        finalizes its ticket directly (there is no per-row assembly for a
        write: the result is the mutation's own return value) and purges
        the tenant's result cache before the next batch can serve a
        read."""
        index = self._indexes[name]
        served = 0
        for ticket, op, _ in batch:
            kind, payload = op
            try:
                with self._scope(name):
                    if kind == "insert":
                        out = index.insert(payload)
                        rows = int(np.asarray(payload).shape[0])
                        counter = "inserts"
                    else:
                        out = index.delete(payload)
                        rows = int(np.asarray(payload).size)
                        counter = "deletes"
            except BaseException as e:
                with self._lock:
                    self._cache_purge(name)  # a partial apply still mutates
                    self._fail(ticket, e)
                served += 1
                continue
            with self._lock:
                self._cache_purge(name)
                w = self._tenant_writes.setdefault(
                    name, {"inserts": 0, "deletes": 0, "write_ops": 0}
                )
                w[counter] += rows
                w["write_ops"] += 1
                ticket._result = out
                self._served += 1
                self._meter(name, ticket.spec, ticket.metric).latencies.append(
                    time.perf_counter() - ticket.submitted_at
                )
                ticket._event.set()
            served += 1
        return served

    # workload execution ------------------------------------------------

    def _run_workloads(self, name, batch) -> int:
        """Run one batch of graph-workload tickets in submission order.
        Each finalizes its ticket directly (the result is one whole
        artifact, not per-row assembly); the build's self-query runs
        under ``_serve_lock`` like any other plan execution — one query
        stream per server at a time."""
        # imported here, not at module top: repro_torch.workloads imports
        # repro_torch.api.query, and importing it while repro_torch.api's
        # own __init__ is still executing would cycle
        from ..workloads import build_knn_graph, dbscan

        index = self._indexes[name]
        served = 0
        for ticket, op, _ in batch:
            kind, kw = op
            rows = int(index.n_points)
            try:
                with self._serve_lock, self._scope(name):
                    if kind == "graph":
                        out = build_knn_graph(
                            index, kw["k"], symmetrize=kw["symmetrize"],
                            metric=kw["metric"], chunk_rows=kw["chunk_rows"],
                        )
                        counter = "graphs"
                    else:
                        out = dbscan(
                            index, kw["eps"], kw["min_pts"],
                            metric=kw["metric"], chunk_rows=kw["chunk_rows"],
                        )
                        counter = "clusters"
            except BaseException as e:
                with self._lock:
                    self._fail(ticket, e)
                served += 1
                continue
            with self._lock:
                w = self._tenant_workloads.setdefault(
                    name, {"graphs": 0, "clusters": 0, "workload_rows": 0}
                )
                w[counter] += 1
                w["workload_rows"] += rows
                ticket._result = out
                self._served += 1
                self._meter(name, ticket.spec, ticket.metric).latencies.append(
                    time.perf_counter() - ticket.submitted_at
                )
                ticket._event.set()
            served += 1
        return served

    # batch execution --------------------------------------------------

    def _run_batch(self, name, spec, metric, batch) -> int:
        m = len(batch)
        if m == 0:
            return 0
        rows = np.stack([row for (_, _, row) in batch])
        # RTNN batch reordering: Z-order-sort the coalesced rows so
        # spatially close queries sit together in the engine's tiles and
        # radius rounds, then unsort on completion.  pos[bi] is where batch
        # item bi's answer row landed; answers are row-independent, so
        # served results are unchanged.
        reordered = self.reorder == "morton" and m > 1
        if reordered:
            order = np.argsort(morton_codes(rows), kind="stable")
            rows = rows[order]
            pos = np.empty((m,), np.int64)
            pos[order] = np.arange(m)
        m_pad = _next_pow2(m) if self.pad_pow2 else m
        if m_pad > m:
            # pad with copies of row 0: every backend treats them as real
            # queries (cheap, exact), and they are sliced off below
            rows = np.concatenate([rows, np.repeat(rows[:1], m_pad - m, 0)])
        plan = self._plan_for(name, spec, metric)
        t0 = time.perf_counter()
        try:
            # one plan execution in flight at a time, on the tenant's device
            with self._serve_lock, self._scope(name):
                res = plan(rows)
        except BaseException as e:
            # fail every ticket in the batch rather than stranding waiters
            with self._lock:
                for ticket, _, _ in batch:
                    self._fail(ticket, e)
            return m
        service = time.perf_counter() - t0
        plan = res.timings.get("plan", "native")

        is_range = isinstance(res, RangeResult)
        tickets = set()
        with self._lock:
            for bi, (ticket, li, row) in enumerate(batch):
                if ticket._event.is_set():
                    continue  # an earlier batch of this ticket failed
                ri = int(pos[bi]) if reordered else bi
                payload = (
                    self._range_row(res, ri)
                    if is_range
                    else self._knn_row(res, ri)
                )
                self._cache_put(name, spec, metric, row, payload)
                self._fill_row(ticket, li, payload)
                # per-row share of the batch's work; float so the
                # remainder isn't truncated away row by row
                ticket._asm["n_tests"] += res.n_tests / m_pad
                ticket._asm["batch_sizes"].append(m)
                tickets.add(ticket)
            self._meter(name, spec, metric).record_batch(
                m, reordered=reordered,
                resolved_radius_p50=res.timings.get("resolved_radius_p50"),
            )
            for ticket in tickets:
                if ticket._rows_left == 0:
                    self._finalize(ticket, plan=plan, service=service)
        return m

    @staticmethod
    def _knn_row(res: KNNResult, i: int) -> tuple:
        return (
            "knn",
            res.dists[i].copy(),
            res.idxs[i].copy(),
            None if res.found is None else int(res.found[i]),
        )

    @staticmethod
    def _range_row(res: RangeResult, i: int) -> tuple:
        idx, dst = res.neighbors(i)
        return (
            "range",
            idx.copy(),
            dst.copy(),
            None if res.truncated is None else bool(res.truncated[i]),
            float(res.radius),
        )

    def _fill_row(self, ticket: Ticket, li: int, payload) -> None:
        ticket._asm["rows"][li] = payload
        ticket._rows_left -= 1

    def _fail(self, ticket: Ticket, error: BaseException) -> None:
        if ticket._event.is_set():
            return
        ticket._error = error
        self._served += 1
        self._meter(ticket.index_name, ticket.spec, ticket.metric).latencies.append(
            time.perf_counter() - ticket.submitted_at
        )
        ticket._event.set()

    def _finalize(self, ticket: Ticket, *, plan: str, service: float = 0.0):
        try:
            ticket._result = self._assemble(ticket, plan, service)
        except BaseException as e:  # surfaced at ticket.result()
            ticket._error = e
        self._served += 1
        self._meter(ticket.index_name, ticket.spec, ticket.metric).latencies.append(
            time.perf_counter() - ticket.submitted_at
        )
        ticket._event.set()

    def _assemble(self, ticket: Ticket, plan: str, service: float):
        rows = ticket._asm["rows"]
        timings = {
            "plan": plan,
            "server_batch_rows": (
                max(ticket._asm["batch_sizes"])
                if ticket._asm["batch_sizes"] else 0
            ),
            "server_cache_hits": ticket._asm["cache_hits"],
            "service_seconds": service,
            "request_seconds": time.perf_counter() - ticket.submitted_at,
        }
        if rows and rows[0][0] == "range":
            offsets = np.zeros((len(rows) + 1,), np.int64)
            for i, r in enumerate(rows):
                offsets[i + 1] = offsets[i] + len(r[1])
            idxs = (
                np.concatenate([r[1] for r in rows])
                if offsets[-1] else np.empty((0,), np.int32)
            ).astype(np.int32)
            dists = (
                np.concatenate([r[2] for r in rows])
                if offsets[-1] else np.empty((0,), np.float32)
            ).astype(np.float32)
            truncated = (
                None
                if any(r[3] is None for r in rows)
                else np.asarray([r[3] for r in rows], bool)
            )
            return RangeResult(
                offsets=offsets,
                idxs=idxs,
                dists=dists,
                radius=rows[0][4],
                n_tests=int(round(ticket._asm["n_tests"])),
                backend=self._indexes[ticket.index_name].backend_name,
                metric=ticket.metric,
                truncated=truncated,
                timings=timings,
            )
        dists = np.stack([r[1] for r in rows])
        idxs = np.stack([r[2] for r in rows])
        found = (
            None
            if any(r[3] is None for r in rows)
            else np.asarray([r[3] for r in rows], np.int64)
        )
        return KNNResult(
            dists=dists,
            idxs=idxs,
            n_tests=int(round(ticket._asm["n_tests"])),
            backend=self._indexes[ticket.index_name].backend_name,
            metric=ticket.metric,
            found=found,
            timings=timings,
        )
