"""The drivers: one run of one cell, from set-up through the measured
window to the comparison with the reference.

A traffic file's ``kind`` names its driver, ``kinds/<kind>.py``, found by
that name (``spec.load_kind``); ``run_cell`` sets the run up and hands it
over.  What every driver shares is here: the warm-up's sums
(``_note_warm``), the numeric entries of a result's ``timings`` that a
window batch keeps (``_numeric``), the index's grid builds
(``_grid_builds``), the card's sync (``_sync``), the collector's state
around the window (``_steady``, ``_release``) and the comparison with the
reference (``_check``).

The program is imported inside the functions, from ``repro_torch`` only.
What the drivers record (``RunRecord``) is all that the metric readers
see.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import numbers
import time

import numpy as np

from . import compare, reference
from .datagen import make_cloud
from .spec import load_kind

__all__ = ["RunRecord", "run_cell"]


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
    #: n_tests, start radius, and the numeric entries of the result's
    #: ``timings`` (the program's counters of that call)
    batches: list = dataclasses.field(default_factory=list)
    warmup_grid_build_s: float = 0.0
    warmup_grid_builds: int = 0
    #: the numeric entries of every warm-up call's ``timings``, summed key
    #: by key
    warmup_timings: dict = dataclasses.field(default_factory=dict)
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


def _numeric(timings: dict) -> dict:
    """A new dict of the numeric entries of a result's ``timings`` (flags,
    names and None left out)."""
    return {key: v for key, v in timings.items()
            if isinstance(v, numbers.Real) and not isinstance(v, bool)}


def _note_warm(rec: RunRecord, res) -> None:
    rec.warmup_grid_build_s += float(res.timings.get("grid_build_seconds",
                                                     0.0))
    rec.warmup_grid_builds += int(res.timings.get("grid_builds", 0))
    for key, v in _numeric(res.timings).items():
        rec.warmup_timings[key] = rec.warmup_timings.get(key, 0) + v


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


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float = None,
             sizes: dict = None) -> RunRecord:
    """One run of ``cell``.  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (set-up is counted from it).  ``sizes``
    overrides the configuration's ``n_points`` and the traffic's sizes, for
    tests on the CPU (a cell's ``cpu_test``); a measured run passes
    none."""
    from repro_torch import build_index

    cfg = dict(cell.config)
    if sizes:
        cfg.update({k: v for k, v in sizes.items() if k in cfg})
        cell = dataclasses.replace(cell, config=cfg, traffic={
            **cell.traffic,
            **{k: v for k, v in sizes.items() if k in cell.traffic}})
    kind = load_kind(cell.traffic["kind"], cell.home)
    rec = RunRecord(cell=cell.name, seed=int(seed), seconds=float(seconds),
                    device=device, n_points=int(cfg["n_points"]),
                    dim=int(cfg["dim"]), k=int(cfg["k"]))
    # set-up is counted from the process's start to the window's
    rec.setup_s = time.perf_counter() if t_start is None else t_start
    if device.startswith("cuda"):
        from repro_torch.kernels.build import extension

        extension()
    cloud = make_cloud(cfg, cell.home)
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
