"""End-to-end driver: serve batched kNN queries against a resident dataset —
the paper's workload as a service, on the build-once / query-many API
(the port's twin of ``examples/serve_knn.py``).

The index is built once; each batch is a pure ``query`` call.  Watch the
per-batch counters: batch 0 pays start-radius sampling and grid builds;
later batches reuse cached grids (``hits``) and warm-start their radius
from the previous batches' resolved-radius distribution, so they run
fewer rounds.

    PYTHONPATH=src python -m repro_torch.examples.serve_knn [--n 50000] \
        [--batches 5] [--device cuda]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    from repro_torch import KnnSpec, build_index, make_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    pts = make_dataset("kitti", args.n, seed=0)  # resident LiDAR-like cloud
    rng = np.random.default_rng(1)

    t0 = time.perf_counter()
    index = build_index(pts, backend="trueknn", device=args.device)
    print(
        f"dataset resident: {args.n} points on {index.device}, index built "
        f"in {(time.perf_counter()-t0)*1e3:.0f} ms; serving {args.batches} "
        f"query batches"
    )

    lat, timings = [], []
    for b in range(args.batches):
        # queries arrive near the data manifold + some far away (hard cases)
        qs = pts[rng.integers(0, args.n, args.batch_size)] + rng.normal(
            scale=0.5, size=(args.batch_size, 3)
        ).astype(np.float32)
        t0 = time.perf_counter()
        res = index.query(qs, KnnSpec(args.k))
        dt = time.perf_counter() - t0
        lat.append(dt)
        tm = res.timings
        timings.append(tm)
        print(
            f"batch {b}: {args.batch_size} queries, k={args.k}, "
            f"{res.n_rounds} rounds, {dt*1e3:.0f} ms "
            f"({dt/args.batch_size*1e6:.0f} us/query) | "
            f"grid builds={tm['grid_builds']} hits={tm['grid_cache_hits']} "
            f"start={tm['start_radius_source']}"
        )

    print(
        f"p50 batch latency {np.median(lat)*1e3:.0f} ms "
        f"(batch 0 pays sampling + grid builds; "
        f"steady state {min(lat)*1e3:.0f} ms)"
    )
    print(f"index stats: {index.stats()}")
    return {"timings": timings, "latency_s": lat}


if __name__ == "__main__":
    main()
