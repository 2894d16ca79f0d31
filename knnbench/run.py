"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 knnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  Needs as
many CUDA cards as the cell asks for, and exits with a code other than 0,
printing no result, where they are missing; there is no CPU fallback.
With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the result
carries its per-layer metrics, the device's busy and window seconds and a
breakdown.  Either way the answers of the window are held against the
plain reference afterwards, and the numbers compared are printed beside
their limits, last on standard error and last in the result line.

The kernels' build goes to ``build/torch_ext`` in the checkout (the
program's own path); Triton's and PyTorch's extension caches are pointed
at ``build/`` too, so a second run builds nothing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded in a measured run: JAX
#: and the JAX package that the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is a forbidden
    one, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _num(x):
    return x if isinstance(x, int) else float(x)


def result_line(rec, cell, trace: bool, kind: str) -> dict:
    from knnbench import compare
    from knnbench.spec import load_reader

    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = load_reader(m["name"], cell.home)(rec)
        # a reader that finds nothing returns None
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": _num(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {
        "correct": compare.judge(rec.checks),
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": metrics,
        "device": device,
    }
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": rec.trace.device_ops,
                             "idle_gaps": rec.trace.idle_gaps}
    line["checks"] = compare.checks_line(rec.checks)
    return line


def diagnostics(rec) -> str:
    """What the run saw besides its metrics, one line for standard
    error."""
    parts = [f"cell={rec.cell}", f"seed={rec.seed}",
             f"setup_s={rec.setup_s:.3f}", f"window_s={rec.window_s:.3f}",
             f"attempted={rec.attempted}", f"failed={rec.failed}",
             f"warmup_grid_builds={rec.warmup_grid_builds}",
             f"warmup_grid_build_s={rec.warmup_grid_build_s:.3f}",
             f"window_grid_builds={rec.window_grid_builds}",
             f"rows_checked={rec.rows_checked}",
             f"memory_peak_bytes={rec.memory_peak_bytes}"]
    if rec.trace is not None:
        parts.append(f"trace_bytes={rec.trace.trace_bytes}")
    if rec.batches:
        rows = sum(b["rows"] for b in rec.batches)
        parts.append(f"batches={len(rec.batches)}")
        parts.append("rounds_mean=%.3f" % (
            sum(len(b["rounds"]) for b in rec.batches) / len(rec.batches)))
        parts.append("tests_per_query=%.1f" % (
            sum(b["n_tests"] for b in rec.batches) / rows))
        radii = sorted({b["start_radius"] for b in rec.batches})
        parts.append(f"start_radii={radii[:4]}")
    return " ".join(parts)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from knnbench.spec import load_benchmark, resolve_cell

    cell = resolve_cell(load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"knnbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from knnbench.drivers import run_cell

    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    line = result_line(rec, cell, bool(args.trace),
                       torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"knnbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(diagnostics(rec), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
