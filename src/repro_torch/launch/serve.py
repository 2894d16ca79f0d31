"""Serving launcher of the port: batched LM serving on any arch, or
neighbor-search serving through the ``NeighborServer`` front-end, on the
card (``--device cuda``, the default) or on the CPU (``--device cpu``:
the kernels' plain versions).

    # LM serving (batched, greedy) on the arch's smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 16 --max-new 24

    # neighbor search, open loop: Poisson arrivals hit the microbatching
    # server at --rate requests/second (each request = one query point)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --backend trueknn --spec hybrid --k 8 --arrival open --rate 500

    # sharded fabric end to end: a spatially-partitioned composite index
    # (N shards, radius-aware shard pruning) registered under a tenant
    # name on the multi-tenant server
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --backend sharded --shards 8 --index lidar --arrival open --rate 500

    # device-parallel placement: pin shard blocks to the positions of an
    # 8-position 1-D DeviceMesh over the visible cards (positions cycle
    # over the cards when there are fewer; with --device cpu every
    # position is the CPU) and serve every shared-cut round as one fused
    # dispatch
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --backend sharded --shards 8 --placement devices --devices 8

    # closed loop (the pre-server demo shape, kept for comparison): one
    # fixed-size batch in flight at a time
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --arrival closed --batches 6 --batch-size 512

    # graph workloads: build the resident cloud's kNN graph, or DBSCAN-
    # cluster it, through the server's workload queue (submit_graph /
    # submit_cluster tickets)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode graph \
        --backend sharded --shards 8 --k 8 --symmetrize union
    PYTHONPATH=src python -m repro_torch.launch.serve --mode dbscan \
        --backend trueknn --eps 1.5 --min-pts 8

    # mutating tenant: a Poisson write stream (--mutate writes/second of
    # inserts and deletes through the server's write queue) interleaves
    # with the read loop; the loop runs twice — compaction on, then off —
    # and reports read p99 for each
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --arrival open --rate 500 --mutate 50
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np


def _lm_params(cfg, device):
    """The served model: random weights from seed 0 on ``device``."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.models import init_params

    dev = resolve_device(device)
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _run_lm(args):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import BatchedServer, ServeConfig

    cfg = smoke_config(get_config(args.arch))
    params = _lm_params(cfg, args.device)
    server = BatchedServer(
        cfg, params, ServeConfig(batch_slots=args.slots, temperature=0.0)
    )
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        server.submit(rng.integers(0, cfg.vocab_size, plen).tolist())

    t0 = time.perf_counter()
    outs = server.run(max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    total_toks = sum(len(o) for o in outs)
    print(
        f"served {len(outs)} requests, {total_toks} tokens in {dt:.2f}s "
        f"({total_toks/dt:.0f} tok/s)"
    )
    print("sample completion:", outs[0][:12])


def _mesh(args):
    """``--devices N``: an N-position 1-D ``DeviceMesh`` over the visible
    cards, cycling over them when there are fewer than N (the CPU at every
    position with ``--device cpu``)."""
    import torch

    from repro_torch import DeviceMesh

    n = int(args.devices)
    if torch.device(args.device).type == "cpu":
        devs = ["cpu"] * n
    else:
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not cards:
            raise SystemExit("--devices needs a visible card (or --device "
                             "cpu)")
        devs = [cards[i % len(cards)] for i in range(n)]
    mesh = DeviceMesh(devs)
    print(f"mesh: {n} positions over {len(set(devs))} device(s) "
          f"{sorted(set(devs))}")
    return mesh


def _build(args, pts):
    """The resident index the CLI asks for, on ``--device``."""
    from repro_torch.api import build_index

    cfg = {"device": args.device}
    if args.backend == "sharded":
        cfg["n_shards"] = args.shards
        cfg["placement"] = args.placement
    if args.devices is not None and (
        args.backend == "distributed"
        or (args.backend == "sharded" and args.placement == "devices")
    ):
        cfg["mesh"] = _mesh(args)
    return build_index(pts, backend=args.backend, **cfg)


def _make_spec(args, warm_dists, index):
    """Spec from CLI knobs; radius defaults to the warm batch's median
    *finite* k-th-NN distance (falling back to the index's sampled radius
    when no warm query filled k — see ``warm_default_radius``)."""
    from repro_torch.api import (HybridSpec, KnnSpec, RangeSpec,
                                 warm_default_radius)

    if args.spec == "knn":
        return KnnSpec(args.k)
    r = args.radius
    if r is None:
        r = warm_default_radius(warm_dists, index)
    if args.spec == "range":
        return RangeSpec(r, max_neighbors=args.max_neighbors)
    if args.spec == "hybrid":
        return HybridSpec(args.k, r)
    raise SystemExit(f"unknown --spec {args.spec!r}")


def _describe(res):
    from repro_torch.api import RangeResult, dropped_counts

    plan = res.timings.get("plan", "native")
    if isinstance(res, RangeResult):
        rows_max = int(res.counts.max()) if res.n_queries else 0
        return f"plan={plan} nnz={len(res.idxs)} rows_max={rows_max}"
    partial, empty = dropped_counts(res.dists)
    return f"plan={plan} dropped_partial={partial} dropped_empty={empty}"


def _closed_loop(server, spec, args, pts, rng):
    """One batch in flight at a time (the pre-server demo loop, through the
    server so its cache/metering still apply)."""
    from repro_torch.api import AdmissionError

    lat = []
    for b in range(args.batches):
        qs = pts[rng.integers(0, args.n, args.batch_size)] + rng.normal(
            scale=0.5, size=(args.batch_size, pts.shape[1])
        ).astype(np.float32)
        t0 = time.perf_counter()
        try:
            res = server.submit(
                qs, spec, metric=args.metric, index=args.index
            ).result()
        except AdmissionError as e:
            print(f"batch {b}: shed by admission control ({e})")
            continue
        dt = time.perf_counter() - t0
        lat.append(dt)
        print(
            f"batch {b}: {dt*1e3:.0f} ms "
            f"({dt/args.batch_size*1e6:.0f} us/query) {_describe(res)}"
        )
    if lat:
        print(
            f"p50 batch latency {np.median(lat)*1e3:.0f} ms "
            f"(steady state {min(lat)*1e3:.0f} ms)"
        )


def _open_loop(server, spec, args, pts, rng):
    """Poisson open-loop arrivals: requests (one query point each) arrive at
    ``--rate`` req/s regardless of completions — the serving regime where
    microbatching actually earns its keep."""
    from repro_torch.api.server import poisson_open_loop

    n_req = args.batches * args.batch_size
    qs = pts[rng.integers(0, args.n, n_req)] + rng.normal(
        scale=0.5, size=(n_req, pts.shape[1])
    ).astype(np.float32)
    results, wall, lat = poisson_open_loop(
        server, qs, spec, args.rate, rng, metric=args.metric,
        index=args.index,
    )
    partial = sum(dropped_counts_row(r) for r in results)
    served = len(results)
    print(
        f"open loop: {served}/{n_req} requests served in {wall:.2f}s "
        f"(offered {args.rate:.0f}/s, served {served/wall:.0f}/s, "
        f"shed {n_req - served})"
    )
    if served:
        print(
            f"request latency p50 {np.percentile(lat, 50)*1e3:.1f} ms "
            f"p99 {np.percentile(lat, 99)*1e3:.1f} ms; "
            f"dropped_partial={partial}"
        )


def dropped_counts_row(res) -> int:
    from repro_torch.api import RangeResult, dropped_counts

    if isinstance(res, RangeResult):
        return 0
    return dropped_counts(res.dists)[0]


def _poisson_writer(server, args, pts, rng, stop, tenant, counts):
    """Poisson write stream: inserts of small row batches sampled near the
    dataset, with occasional deletes of ids this stream minted earlier.
    Writes go through the server's write queue, so they interleave with
    reads in arrival order (every read sees the writes that beat it in)."""
    d = pts.shape[1]
    pool: list = []
    while not stop.is_set():
        if stop.wait(rng.exponential(1.0 / args.mutate)):
            return
        try:
            if pool and rng.random() < 0.25:
                take = int(min(len(pool), 1 + rng.integers(0, 8)))
                sel = sorted(
                    map(int, rng.choice(len(pool), size=take, replace=False)),
                    reverse=True,
                )
                ids = [pool.pop(i) for i in sel]
                server.submit_delete(ids, index=tenant).result(timeout=120)
                counts["deletes"] += take
            else:
                m = 8
                rows = (
                    pts[rng.integers(0, len(pts), m)]
                    + rng.normal(scale=0.05, size=(m, d))
                ).astype(np.float32)
                minted = server.submit_insert(rows, index=tenant).result(
                    timeout=120
                )
                pool.extend(int(i) for i in minted)
                counts["inserts"] += m
        except Exception:  # keep the stream alive; totals tell the story
            counts["errors"] += 1


def _run_mutating(base, spec, args, pts, rng):
    """Serve the read loop twice under the Poisson write stream — once
    with background compaction, once with compaction off — and report
    read p99 for each: what a read pays for riding an ever-growing delta
    log vs what it pays for sharing the tenant with rebuilds."""
    from repro_torch.api import NeighborServer, make_mutable

    p99 = {}
    for mode in ("background", "off"):
        index = make_mutable(
            base, delta_rows=max(512, args.n // 50), auto_compact=mode
        )
        server = NeighborServer(
            indexes={args.index: index},
            max_batch=args.batch_size,
            cache_size=args.cache_size,
            max_queue=args.max_queue,
        )
        server.prepare(spec, metric=args.metric, index=args.index)
        print(
            f"serving ({args.arrival} loop) with --mutate "
            f"{args.mutate:.0f} writes/s, auto_compact={mode!r}"
        )
        stop = threading.Event()
        counts = {"inserts": 0, "deletes": 0, "errors": 0}
        writer = threading.Thread(
            target=_poisson_writer,
            args=(server, args, pts, np.random.default_rng(7), stop,
                  args.index, counts),
            daemon=True,
        )
        writer.start()
        try:
            if args.arrival == "closed":
                _closed_loop(server, spec, args, pts, rng)
            else:
                _open_loop(server, spec, args, pts, rng)
        finally:
            stop.set()
            writer.join()
        s = server.stats()
        read_p99 = [
            b["latency_p99_ms"]
            for key, b in s["buckets"].items()
            if "/write/" not in key and b["latency_p99_ms"] is not None
        ]
        p99[mode] = max(read_p99) if read_p99 else None
        st = s["indexes"][args.index]
        print(
            f"  writes: +{counts['inserts']} rows, -{counts['deletes']} rows "
            f"({counts['errors']} errors); index: base={st['base_rows']} "
            f"delta={st['delta_rows']} tombstones={st['tombstones']} "
            f"compactions={st['compactions']}; read p99 {p99[mode]} ms"
        )
    if all(v is not None for v in p99.values()):
        print(
            f"read p99: {p99['background']} ms with compaction vs "
            f"{p99['off']} ms without"
        )


def _run_knn(args):
    from repro_torch.api import KnnSpec, NeighborServer
    from repro_torch.core import make_dataset

    pts = make_dataset(args.dataset, args.n, seed=0)
    rng = np.random.default_rng(1)

    t0 = time.perf_counter()
    index = _build(args, pts)
    shards = f", {args.shards} shards" if args.backend == "sharded" else ""
    print(
        f"dataset resident: {args.n} {args.dataset} points "
        f"(backend={args.backend}{shards}, index={args.index!r}, "
        f"device={index.device}), built in "
        f"{(time.perf_counter()-t0)*1e3:.0f} ms"
    )
    # warm batch: pays sampling/grid builds/jit, and sizes the default radius
    warm = index.query(
        pts[rng.integers(0, args.n, args.batch_size)], KnnSpec(args.k),
        metric=args.metric,
    )
    spec = _make_spec(args, warm.dists, index)
    if args.mutate > 0:
        _run_mutating(index, spec, args, pts, rng)
        return
    server = NeighborServer(
        indexes={args.index: index},
        max_batch=args.batch_size,
        cache_size=args.cache_size,
        max_queue=args.max_queue,
    )
    print(
        f"serving ({args.arrival} loop): {spec} metric={args.metric} "
        f"max_batch={args.batch_size} cache={args.cache_size} "
        f"max_queue={args.max_queue}"
    )
    # prepare the serving plan up front (moves route construction out of
    # the first request's latency); --explain prints the structured trees
    server.prepare(spec, metric=args.metric, index=args.index)
    if args.explain:
        import json

        print("active plan trees (per tenant):")
        print(json.dumps(server.active_plans(), indent=2, default=str))

    if args.arrival == "closed":
        _closed_loop(server, spec, args, pts, rng)
    else:
        _open_loop(server, spec, args, pts, rng)

    s = server.stats()
    for name, b in s["buckets"].items():
        print(
            f"bucket {name}: {b['requests']} reqs in {b['batches']} batches "
            f"(mean {b['mean_batch_rows']} rows/batch, hist "
            f"{b['batch_size_hist']}), p50 {b['latency_p50_ms']} ms "
            f"p99 {b['latency_p99_ms']} ms, cache_hit_rate "
            f"{b['cache_hit_rate']}, reordered {b['reordered_batches']}, "
            f"plan_cache {b['plan_cache']['hits']}h/"
            f"{b['plan_cache']['misses']}m"
        )
    if s["rejected"]:
        print(f"admission control shed {s['rejected']} requests")
    for name, st in s["indexes"].items():
        if st.get("backend") == "sharded":
            print(
                f"index {name!r}: {st['n_shards']} shards "
                f"(sizes {st['shard_sizes']}), prune_rate "
                f"{st['prune_rate']} ({st['shard_visits_pruned']} of "
                f"{st['shard_visits'] + st['shard_visits_pruned']} visits "
                "skipped)"
            )
        else:
            print(f"index {name!r} stats: {st}")
    for name, p in s["placement"]["tenants"].items():
        print(
            f"placement {name!r}: {p['slots']} slots on {p['devices']} "
            f"devices, occupancy {p['device_occupancy']}, "
            f"{p['fused_dispatches']} fused dispatches, "
            f"{p['rebalances']} rebalances"
        )


def _run_workload(args):
    """Graph workloads through the server's workload queue: build the
    resident index, register it as a tenant, and submit one
    ``submit_graph`` (``--mode graph``) or ``submit_cluster``
    (``--mode dbscan``) ticket — the batch-analytics serving shape."""
    from repro_torch.api import NeighborServer
    from repro_torch.core import make_dataset

    pts = make_dataset(args.dataset, args.n, seed=0)
    t0 = time.perf_counter()
    index = _build(args, pts)
    print(
        f"dataset resident: {args.n} {args.dataset} points "
        f"(backend={args.backend}, index={args.index!r}, "
        f"device={index.device}), built in "
        f"{(time.perf_counter()-t0)*1e3:.0f} ms"
    )
    server = NeighborServer(indexes={args.index: index})
    t0 = time.perf_counter()
    if args.mode == "graph":
        ticket = server.submit_graph(
            args.k, symmetrize=args.symmetrize, metric=args.metric,
            index=args.index,
        )
        g = ticket.result(timeout=600)
        dt = time.perf_counter() - t0
        deg = g.counts
        print(
            f"kNN graph (k={g.k}, symmetrize={g.symmetrize!r}): "
            f"{g.n} nodes, {g.n_edges} edges in {dt:.2f}s "
            f"({g.n/dt:.0f} rows/s); degree min {int(deg.min())} "
            f"median {int(np.median(deg))} max {int(deg.max())}; "
            f"generation {g.generation}"
        )
    else:
        eps = args.eps
        if eps is None:
            # size eps like the serving radius default: median k-th-NN
            # distance of a warm sample (see warm_default_radius)
            from repro_torch.api import KnnSpec, warm_default_radius

            rng = np.random.default_rng(1)
            warm = index.query(
                pts[rng.integers(0, args.n, min(args.n, 512))],
                KnnSpec(args.min_pts), metric=args.metric,
            )
            eps = warm_default_radius(warm.dists, index)
            print(f"--eps not given; using warm median {eps:.4f}")
        ticket = server.submit_cluster(
            eps, args.min_pts, metric=args.metric, index=args.index
        )
        c = ticket.result(timeout=600)
        dt = time.perf_counter() - t0
        sizes = np.bincount(c.labels[c.labels >= 0]) if c.n_clusters else []
        print(
            f"DBSCAN(eps={c.eps:.4f}, min_pts={c.min_pts}): "
            f"{c.n_clusters} clusters, {int(c.core.sum())} core points, "
            f"{c.n_noise} noise of {len(c.labels)} in {dt:.2f}s; "
            f"largest cluster {int(max(sizes)) if len(sizes) else 0} rows"
        )
    w = server.stats()["workloads"].get(args.index, {})
    print(f"tenant {args.index!r} workload meter: {w}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "knn", "graph", "dbscan"],
                    default="lm")
    # lm mode
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    # knn mode
    ap.add_argument("--dataset", default="kitti")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--backend", default="trueknn")
    ap.add_argument("--shards", type=int, default=8,
                    help="partition arity for --backend sharded")
    ap.add_argument("--placement", choices=["host", "devices"],
                    default="host",
                    help="sharded shard placement: host = sequential "
                    "per-child queries; devices = pin shard blocks to mesh "
                    "devices and run each shared-cut round as one fused "
                    "dispatch")
    ap.add_argument("--devices", type=int, default=None,
                    help="an N-position 1-D DeviceMesh for --placement "
                    "devices (or the distributed backend): the visible "
                    "cards, cycled when there are fewer than N; the CPU at "
                    "every position with --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="where the index or the model lives: cuda (the "
                    "card, the default) or cpu (the kernels' plain "
                    "versions)")
    ap.add_argument("--index", default="default",
                    help="tenant name the resident index serves under")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound on pending rows (None = unbounded)")
    ap.add_argument("--spec", choices=["knn", "range", "hybrid"], default="knn")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--max-neighbors", type=int, default=None)
    ap.add_argument("--metric", default="l2")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument(
        "--arrival", choices=["open", "closed"], default="closed",
        help="open: Poisson arrivals onto the microbatching server at "
        "--rate req/s; closed: one batch in flight at a time",
    )
    ap.add_argument("--rate", type=float, default=500.0,
                    help="open-loop offered load, requests/second")
    ap.add_argument("--mutate", type=float, default=0.0,
                    help="Poisson write stream, writes/second: wraps the "
                    "index with make_mutable and runs the read loop twice "
                    "(background compaction, then off), reporting read p99 "
                    "for each")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="NeighborServer LRU result-cache rows (0 disables)")
    # graph/dbscan workload modes
    ap.add_argument("--eps", type=float, default=None,
                    help="DBSCAN neighborhood radius (--mode dbscan); "
                    "defaults to the warm median k-th-NN distance")
    ap.add_argument("--min-pts", type=int, default=8,
                    help="DBSCAN core-point density threshold")
    ap.add_argument("--symmetrize", choices=["union", "mutual", "none"],
                    default="union",
                    help="kNN-graph symmetrization mode (--mode graph)")
    ap.add_argument("--explain", action="store_true",
                    help="print each tenant's active structured plan trees "
                    "(plan.explain()) once at startup")
    args = ap.parse_args(argv)
    if args.mode == "knn":
        _run_knn(args)
    elif args.mode in ("graph", "dbscan"):
        _run_workload(args)
    else:
        _run_lm(args)


if __name__ == "__main__":
    main()
