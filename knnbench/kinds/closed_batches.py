"""closed_batches: one client that sends a batch, waits for its answers
on the host, and sends the next, back to back.

``queries: "scan"`` sends fresh scans of ``scan_rows`` points from the
configuration's cloud, cycling through a pool of ``pool`` scans made at
set-up; ``queries: "self"`` asks the whole cloud for its own neighbours
(``query(None, ...)``).  The warm-up makes at most ``warm_passes`` passes
over the pool after its first batch, stopping at one that builds no grid.
``check_rows_per_batch`` rows of every window batch, drawn from the seed,
and at most ``check_rows_max`` in all, are held against the reference
once the window has closed.
"""

import time

import numpy as np

from knnbench.datagen import derive_seed, make_points
from knnbench.drivers import (_check, _grid_builds, _note_warm, _numeric,
                              _release, _steady, _sync)
from knnbench.trace import WINDOW_SPAN, span, traced


def run(rec, cell, make_index, cloud, seed, seconds, trace, device,
        out_trace):
    from repro_torch import KnnSpec

    tr = cell.traffic
    spec = KnnSpec(rec.k)
    if tr["queries"] == "scan":
        rows = int(tr["scan_rows"])
        pool = [make_points(cell.config["dataset"], rows,
                            derive_seed(seed, "scan", i), cell.home)
                for i in range(int(tr["pool"]))]
    elif tr["queries"] == "self":
        rows = rec.n_points
        pool = [None]
    else:
        raise ValueError(f"unknown closed-loop queries {tr['queries']!r}")
    index = make_index()

    # warm-up: the first batch starts from the sampled radius and builds
    # the grids; then passes over the pool until one builds nothing
    _note_warm(rec, index.query(pool[0], spec))
    for _ in range(int(tr.get("warm_passes", 3))):
        before = rec.warmup_grid_builds
        for q in pool:
            _note_warm(rec, index.query(q, spec))
        if rec.warmup_grid_builds == before:
            break
    _sync(device)

    per_batch = int(tr["check_rows_per_batch"])
    check_rng = np.random.default_rng(derive_seed(seed, "check"))
    picks = []  # (pool slot, rows, dists, idxs) of the rows to check
    builds0 = _grid_builds(index)
    _steady()
    rec.setup_s = time.perf_counter() - rec.setup_s
    with traced(trace, out_trace), span(WINDOW_SPAN):
        t0 = time.perf_counter()
        b = 0
        while True:
            q = pool[b % len(pool)]
            with span("knnbench.batch"):
                res = index.query(q, spec)
            pick = check_rng.choice(rows, size=min(per_batch, rows),
                                    replace=False)
            picks.append((b % len(pool), pick, res.dists[pick],
                          res.idxs[pick]))
            rec.batches.append({
                "rows": rows,
                "rounds": [(r.n_queries, r.radius) for r in res.rounds],
                "n_tests": int(res.n_tests),
                "start_radius": res.start_radius,
                "timings": _numeric(res.timings),
            })
            b += 1
            if time.perf_counter() - t0 >= seconds:
                break
        rec.window_s = time.perf_counter() - t0
    rec.window_grid_builds = _grid_builds(index) - builds0
    rec.rows_done = rows * len(rec.batches)
    rec.attempted = rec.rows_done
    del index, res
    rec.memory_peak_bytes = _release(device)

    cap = int(tr.get("check_rows_max", 1 << 15))
    keep = np.arange(sum(len(p[1]) for p in picks))
    if len(keep) > cap:
        keep = np.sort(check_rng.choice(len(keep), size=cap, replace=False))
    slot = np.concatenate([np.full(len(p[1]), p[0]) for p in picks])[keep]
    row = np.concatenate([p[1] for p in picks])[keep]
    port_d = np.concatenate([p[2] for p in picks])[keep]
    port_i = np.concatenate([p[3] for p in picks])[keep]
    if pool[0] is None:
        queries, exclude = cloud[row], row
    else:
        queries = np.stack([pool[s][r] for s, r in zip(slot, row)])
        exclude = None
    _check(rec, cloud, queries, port_d, port_i, exclude, device)
