"""The readings that the limits in ``compare.py`` are set from, on the
card, at a cell's own size.

    python3 knnbench/readings.py --workload kitti-scan2map --seconds 5 \\
        --seeds 1,2,3 --control-seeds 4,5,6

For each of ``--seeds``, one whole run of the cell (set-up, a window of
``--seconds``, the comparison): the program's readings, the lower ends.
For each of ``--control-seeds``, the control put in the program's place:
the reference's search in bfloat16, and in float32 with TF32 matmuls, on
the same cloud and the same kind and number of checked rows that a run
compares; its readings are the upper ends.  One JSON line a reading.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_rows(cell, seed: int):
    """(cloud, queries, exclude) as a run of ``cell`` with ``seed`` would
    check them: rows of its first batch."""
    import numpy as np

    from knnbench.datagen import derive_seed, make_cloud, make_points

    cfg, tr = cell.config, cell.traffic
    cloud = make_cloud(cfg, cell.home)
    rng = np.random.default_rng(derive_seed(seed, "check"))
    if tr["queries"] == "self":
        rows = rng.choice(len(cloud), size=int(tr["check_rows_max"]),
                          replace=False)
        return cloud, cloud[rows], rows
    scan = make_points(cfg["dataset"], int(tr["scan_rows"]),
                       derive_seed(seed, "scan", 0), cell.home)
    rows = rng.choice(len(scan), size=int(tr["check_rows_max"]),
                      replace=False)
    return cloud, scan[rows], None


def control_reading(cell, seed: int, mode: str) -> dict:
    import torch

    from knnbench import compare, reference

    cloud, queries, exclude = control_rows(cell, seed)
    k = int(cell.config["k"])
    pts = torch.from_numpy(cloud).cuda()
    q = torch.from_numpy(queries).cuda()
    ex = None if exclude is None else torch.from_numpy(exclude).cuda()
    if mode == "bf16":
        got_d, got_i = reference.control_knn(pts, q, k, exclude=ex)
    else:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_d, got_i = reference.control_knn(pts, q, k, exclude=ex,
                                                 dtype=torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    ref_d, _ = reference.exact_knn(pts, q, k, exclude=ex)
    at = reference.true_dists(pts, q, got_i)
    numbers = compare.compare_rows(
        got_d.cpu().numpy(), got_i.cpu().numpy(), ref_d.cpu().numpy(),
        at.cpu().numpy(), len(cloud), exclude)
    return {"kind": "control", "mode": mode, "seed": seed,
            "rows": int(len(queries)), **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from knnbench import run as runner
    from knnbench.drivers import run_cell
    from knnbench.spec import load_benchmark, resolve_cell

    if not torch.cuda.is_available():
        print("knnbench readings need a CUDA card", file=sys.stderr)
        return 2
    cell = resolve_cell(load_benchmark(ROOT), args.workload)
    for s in filter(None, args.control_seeds.split(",")):
        for mode in ("bf16", "tf32"):
            print(json.dumps(control_reading(cell, int(s), mode)), flush=True)
    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = run_cell(cell, int(s), args.seconds, False, device="cuda",
                       t_start=t0)
        line = runner.result_line(rec, cell, False,
                                  torch.cuda.get_device_name(0))
        print(json.dumps({"kind": "program", "seed": int(s),
                          "rows": rec.rows_checked, **rec.checks,
                          "correct": line["correct"],
                          "metrics": line["metrics"],
                          "diag": runner.diagnostics(rec),
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
