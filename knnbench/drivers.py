"""The drivers: one run of one cell, from set-up through the measured
window to the comparison with the reference.

A traffic file's ``kind`` picks the driver.  The one there is,
``closed_batches``, is one client that sends a batch, waits for its
answers on the host, and sends the next, back to back.  ``queries:
"scan"`` sends fresh scans of ``scan_rows`` points from the
configuration's generator, cycling through a pool of ``pool`` scans made
at set-up; ``queries: "self"`` asks the whole cloud for its own
neighbours (``query(None, ...)``).

The program is imported inside the functions, from ``repro_torch`` only.
What the drivers record (``RunRecord``) is all that the metric readers
see.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np

from . import compare, reference
from .datagen import derive_seed, make_cloud, make_points
from .trace import WINDOW_SPAN, span, traced

__all__ = ["RunRecord", "KINDS", "run_cell"]


@dataclasses.dataclass
class RunRecord:
    cell: str
    seed: int
    seconds: float
    device: str
    n_points: int
    dim: int
    k: int
    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    failed: int = 0
    #: the rows of the window's batches
    rows_done: int = 0
    #: one entry a window batch: rows, rounds as (rows, radius) pairs,
    #: n_tests
    batches: list = dataclasses.field(default_factory=list)
    warmup_grid_build_s: float = 0.0
    warmup_grid_builds: int = 0
    window_grid_builds: int = 0
    rows_checked: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: object = None  # trace.TraceSummary of a traced run


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _grid_builds(index) -> int:
    return int(index.stats().get("grid_builds", 0))


def _note_warm(rec: RunRecord, res) -> None:
    rec.warmup_grid_build_s += float(res.timings.get("grid_build_seconds",
                                                     0.0))
    rec.warmup_grid_builds += int(res.timings.get("grid_builds", 0))


def _steady() -> None:
    """Just before the window: collect what set-up left, and move every
    object alive to the collector's permanent generation, so that its
    passes in the window scan only what the window makes."""
    gc.collect()
    gc.freeze()


def _release(device) -> int:
    """After the window, once the caller has dropped the program's
    objects: collect them, return the card's memory, and give the peak
    read before."""
    import torch

    gc.unfreeze()
    if not str(device).startswith("cuda"):
        gc.collect()
        return 0
    peak = int(torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def _check(rec: RunRecord, cloud, queries, port_d, port_i, exclude,
           device) -> None:
    """Hold the program's answers for ``queries`` against the reference's,
    on ``device``, and record the numbers compared."""
    import torch

    pts = torch.from_numpy(np.ascontiguousarray(cloud)).to(device)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    ex = (None if exclude is None
          else torch.from_numpy(np.asarray(exclude, np.int64)).to(device))
    ref_d, _ = reference.exact_knn(pts, q, rec.k, exclude=ex)
    safe = np.clip(np.asarray(port_i, np.int64), 0, rec.n_points - 1)
    at_port = reference.true_dists(pts, q, torch.from_numpy(safe).to(device))
    numbers = compare.compare_rows(port_d, port_i, ref_d.cpu().numpy(),
                                   at_port.cpu().numpy(), rec.n_points,
                                   exclude)
    rec.checks.update(numbers)
    rec.rows_checked = int(len(queries))


def _closed_batches(rec, cell, make_index, cloud, seed, seconds, trace,
                    device, out_trace):
    from repro_torch import KnnSpec

    tr = cell.traffic
    spec = KnnSpec(rec.k)
    if tr["queries"] == "scan":
        rows = int(tr["scan_rows"])
        pool = [make_points(cell.config["dataset"], rows,
                            derive_seed(seed, "scan", i))
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


KINDS = {"closed_batches": _closed_batches}


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float = None,
             sizes: dict = None) -> RunRecord:
    """One run of ``cell``.  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (set-up is counted from it).  ``sizes``
    overrides the configuration's ``n_points`` and the traffic's sizes, for
    tests on the CPU; a measured run passes none."""
    from repro_torch import build_index

    cfg = dict(cell.config)
    if sizes:
        cfg.update({k: v for k, v in sizes.items() if k in cfg})
        cell = dataclasses.replace(cell, config=cfg, traffic={
            **cell.traffic,
            **{k: v for k, v in sizes.items() if k in cell.traffic}})
    kind = KINDS[cell.traffic["kind"]]
    rec = RunRecord(cell=cell.name, seed=int(seed), seconds=float(seconds),
                    device=device, n_points=int(cfg["n_points"]),
                    dim=int(cfg["dim"]), k=int(cfg["k"]))
    # set-up is counted from the process's start to the window's
    rec.setup_s = time.perf_counter() if t_start is None else t_start
    if device.startswith("cuda"):
        from repro_torch.kernels.build import extension

        extension()
    cloud = make_cloud(cfg)
    if cloud.shape[1] != rec.dim:
        raise ValueError(f"{cfg['dataset']} makes {cloud.shape[1]}-D points,"
                         f" the configuration states {rec.dim}")

    def make_index():
        return build_index(cloud, backend=cfg["backend"], device=device,
                           **cfg.get("backend_cfg", {}))

    out_trace: list = []
    kind(rec, cell, make_index, cloud, seed, seconds, trace, device,
         out_trace)
    rec.trace = out_trace[0] if out_trace else None
    return rec
