"""sor_filter: one client that cleans the resident map with the Point
Cloud Library's statistical outlier removal, batch after batch, back to
back: each batch is one ``statistical_outlier_removal(index, mean_k=k,
std_mul)`` call over the whole cloud (one ``AllPairsSpec(k)`` self kNN,
then the keep/drop rule on the host), with ``k`` and ``std_mul`` from the
configuration.

The warm-up makes a first call and then at most ``warm_passes`` more,
stopping at one that builds no grid.  ``check_rows_per_batch`` rows of
every window batch, drawn from the seed, and at most ``check_rows_max``
in all, have their lists held against the reference once the window has
closed; that decides ``correct``.  The decisions are held against the
filter's rule (``sor_reference.bad_rows``) then too: each row that breaks
it counts as failed, and any such row makes the run read not correct.  The
filter's answer is its means and its keep bits, so a mean or a decision
off the rule is a wrong answer, as a list cut short is: the run's
``dist_rel_err`` then reads inf.
"""

import math
import time

import numpy as np

from knnbench import sor_reference
from knnbench.datagen import derive_seed
from knnbench.drivers import (_check, _grid_builds, _note_warm, _numeric,
                              _release, _steady, _sync)
from knnbench.trace import WINDOW_SPAN, span, traced


def run(rec, cell, make_index, cloud, seed, seconds, trace, device,
        out_trace):
    from repro_torch.workloads import statistical_outlier_removal

    tr = cell.traffic
    std_mul = float(cell.config["std_mul"])
    rows = rec.n_points
    index = make_index()

    def sor():
        return statistical_outlier_removal(index, mean_k=rec.k,
                                           std_mul=std_mul)

    # warm-up: the first call starts from the sampled radius and builds
    # the grids; then calls until one builds nothing
    _note_warm(rec, sor())
    for _ in range(int(tr.get("warm_passes", 3))):
        before = rec.warmup_grid_builds
        _note_warm(rec, sor())
        if rec.warmup_grid_builds == before:
            break
    _sync(device)

    per_batch = int(tr["check_rows_per_batch"])
    check_rng = np.random.default_rng(derive_seed(seed, "check"))
    picks = []  # (rows, dists, idxs) of the rows to check
    decisions = []  # (keep, mean_d, threshold) of every batch
    builds0 = _grid_builds(index)
    _steady()
    rec.setup_s = time.perf_counter() - rec.setup_s
    with traced(trace, out_trace), span(WINDOW_SPAN):
        t0 = time.perf_counter()
        while True:
            with span("knnbench.batch"):
                res = sor()
            knn = res.knn
            pick = check_rng.choice(rows, size=min(per_batch, rows),
                                    replace=False)
            picks.append((pick, knn.dists[pick], knn.idxs[pick]))
            decisions.append((res.keep, res.mean_d, res.threshold))
            rec.batches.append({
                "rows": rows,
                "rounds": [(r.n_queries, r.radius) for r in knn.rounds],
                "n_tests": int(knn.n_tests),
                "start_radius": knn.start_radius,
                "timings": _numeric(res.timings),
            })
            if time.perf_counter() - t0 >= seconds:
                break
        rec.window_s = time.perf_counter() - t0
    rec.window_grid_builds = _grid_builds(index) - builds0
    rec.rows_done = rows * len(rec.batches)
    rec.attempted = rec.rows_done
    del index, res, knn
    rec.memory_peak_bytes = _release(device)

    cap = int(tr.get("check_rows_max", 1 << 15))
    keep = np.arange(sum(len(p[0]) for p in picks))
    if len(keep) > cap:
        keep = np.sort(check_rng.choice(len(keep), size=cap, replace=False))
    row = np.concatenate([p[0] for p in picks])[keep]
    port_d = np.concatenate([p[1] for p in picks])[keep]
    port_i = np.concatenate([p[2] for p in picks])[keep]
    _check(rec, cloud, cloud[row], port_d, port_i, row, device)

    for (kept, mean_d, thr), (pick, dists, _) in zip(decisions, picks):
        rec.failed += int(sor_reference.bad_rows(
            kept, mean_d, thr, std_mul, pick, dists).sum())
    if rec.failed:
        rec.checks["dist_rel_err"] = math.inf
