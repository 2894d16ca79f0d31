#!/usr/bin/env python3
"""The ``grid_round`` kernels of two checkouts, timed in turns on one card.

    python3 scripts/grid_round_ab.py --other PATH

Builds this checkout's CUDA extension (``repro_torch.kernels.build``) and
the sources under ``PATH/src/repro_torch/csrc`` (another checkout, such as
the parent commit unpacked with ``git archive``) as a second one
(``ab_common.other_extension``).  The points are kitti 2^20.  Shapes, each
a coarse launch as the wrapper makes it (the cell sort included): every
row on the heaviest grid of the trueknn schedule (res (2, 2, 2), cap
2^19) at k = 8; every row on the counted range's grid (the
``fixed_radius`` index at phase 4's median 8th-NN distance: res (1, 2,
1), cap 2^20) at k = 32, 64, 128 and 256; fused over all rows on the
heaviest grid with 229,049 unresolved at k = 8 (the count of the fused
loop's round after the every-row one, a seeded draw: every row of that
grid tests all N points, so the draw does the round's work), with 206
and with 1 (another seeded draw, ``chip_smoke.py``'s) at k = 8, and with
206 at k = 128.  Each shape runs the other build, this, this, the other,
each on fresh outputs (``ab_common.median_ms``); the two builds' outputs
and test counts must be bitwise equal.  Prints the card's name and power
limit, then one JSON line a shape with its operation bound (3d FP32 flops
a test over the card's FP32 rate).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
from ab_common import (FP32_FLOPS, N, RADIUS, card_line, median_ms,
                       other_extension)

MANY_ROWS = 229_049  # phase 8: the fused round after the every-row one


def launch(ext, pts, grid, q, qid, r2, k, out, tests, unres, res_round,
           executed):
    """One coarse launch through ``ext`` as its wrapper makes it: the
    wrapper's own ``_launch`` for a binding that sizes its workspace
    (``grid_round_workspace_rows``), else the call of the binding before
    the split (no active count, no workspace)."""
    import torch

    from repro_torch.core.fixed_radius import _launch, cell_keys

    if hasattr(ext, "grid_round_workspace_rows"):
        _launch(pts, grid, q, qid, r2, k, True, out=out, tests=tests,
                unres=unres, res_round=res_round, executed=executed, ext=ext)
        return
    perm = torch.argsort(cell_keys(q, grid, unres), stable=True)
    ext.grid_round(pts, grid.buckets, grid.point_cells, grid.origin,
                   grid.inv_cell, grid.res_arr, q, qid, perm, k, r2, True,
                   *out, unres, res_round, 0, tests, executed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("grid_round_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import build_index, make_dataset
    from repro_torch.core.fused_loop import build_schedule
    from repro_torch.kernels import build

    print(card_line(), flush=True)
    exts = {"this": build.extension(), "other": other_extension(args.other)}
    dev = torch.device("cuda")
    pts_np = make_dataset("kitti", N)
    fr = build_index(pts_np, backend="fixed_radius", radius=RADIUS,
                     device=dev)
    tk = build_index(pts_np, backend="trueknn", device=dev)
    r0, _ = tk._start_radius(None)
    tk._set_anchor(r0)
    sched = build_schedule(tk, r0)
    t = max(range(len(sched.grids)),
            key=lambda i: np.prod([min(3, r) for r in sched.grids[i].res])
            * sched.grids[i].cap)
    pts = fr._pts_t
    qid = torch.arange(N, dtype=torch.int32, device=dev)
    draws = {
        m: torch.as_tensor(np.random.default_rng(seed).choice(
            N, size, replace=False)[:m], device=dev)
        for m, seed, size in ((MANY_ROWS, 22, MANY_ROWS), (206, 21, 206),
                              (1, 21, 206))
    }

    def compare(tag, grid, radius, k, active=None):
        r2 = float(np.float32(radius) ** 2)
        unres0 = None
        if active is not None:
            unres0 = torch.zeros(N, dtype=torch.uint8, device=dev)
            unres0[draws[active]] = 1

        def fresh():
            st = [torch.full((N, k), -1.0, device=dev),
                  torch.full((N, k), -1, dtype=torch.int32, device=dev),
                  torch.full((N,), -1, dtype=torch.int32, device=dev),
                  torch.zeros(1, dtype=torch.int64, device=dev)]
            if unres0 is None:
                return st + [None, None, None]
            return st + [unres0.clone(),
                         torch.full((N,), -1, dtype=torch.int32, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev)]

        times = {"other": [], "this": []}
        res = {}
        for name in ("other", "this", "this", "other"):
            ext = exts[name]
            ms, st = median_ms(
                lambda st, ext=ext: launch(ext, pts, grid, pts, qid, r2, k,
                                           tuple(st[:3]), *st[3:]),
                setup=fresh)
            times[name].append(ms)
            res[name] = [x for x in st if x is not None]
        for x, y in zip(res["other"], res["this"]):
            if not torch.equal(x, y):
                raise RuntimeError(f"{tag}: the builds differ")
        n_tests = int(res["this"][3])
        print(json.dumps({"shape": tag, "other_ms": times["other"],
                          "this_ms": times["this"], "n_tests": n_tests,
                          "op_bound_ms": n_tests * 3 * pts.shape[1]
                          / FP32_FLOPS * 1e3}), flush=True)
        del res
        torch.cuda.empty_cache()

    heavy = sched.grids[t]
    hr = sched.radii[t]
    counted, _ = fr._grid_for(RADIUS)
    compare(f"every row res={heavy.res} cap={heavy.cap} k=8", heavy, hr, 8)
    for k in (32, 64, 128, 256):
        compare(f"every row res={counted.res} cap={counted.cap} k={k}",
                counted, RADIUS, k)
    for active, k in ((MANY_ROWS, 8), (206, 8), (1, 8), (206, 128)):
        compare(f"fused {active} of 2^20 rows res={heavy.res} "
                f"cap={heavy.cap} k={k}", heavy, hr, k, active)
    return 0


if __name__ == "__main__":
    sys.exit(main())
