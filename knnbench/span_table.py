"""The program's own spans in a traced run of one cell, as a table.

    python3 knnbench/span_table.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does, and prints its result line as
that does; then, on standard error, one line for each ``repro_torch.*``
span that started inside the measured window, and the idle time inside
none of them.  The table is reduced from the same trace as the result
line (``trace.summarize`` is wrapped for the run to see its events).

For each span name: how often it ran (``n``), its host seconds
(``host_s``), its self seconds, less its child program spans
(``self_s``), the device-idle seconds that passed while it was the
innermost program span (``idle_s``), and the seconds of the device
operations launched inside it, innermost, each kernel or copy matched to
its launch by the trace's ``correlation`` id (``device_s``).  The idle
time inside no program span is ``idle_outside_s``: the harness, the
interpreter and the collector.  The spans' ``idle_s`` and it add up to
the window's idle time.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PROGRAM_PREFIX = "repro_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(starts: np.ndarray, ends: np.ndarray):
    """Time cut at every span edge: (bounds, owner), where ``owner[i]`` is
    the span that is innermost (shortest) over ``[bounds[i],
    bounds[i+1])``, -1 where none covers it."""
    bounds = np.unique(np.concatenate([starts, ends]))
    owner = np.full(len(bounds), -1)
    lo = np.searchsorted(bounds, starts)
    hi = np.searchsorted(bounds, ends)
    for i in np.argsort(starts - ends, kind="stable"):  # longest first
        owner[lo[i]:hi[i]] = i
    return bounds, owner


def _owner_at(bounds, owner, t: np.ndarray) -> np.ndarray:
    """The innermost span at each time of ``t`` (-1 for none)."""
    if not len(bounds):
        return np.full(len(t), -1)
    i = np.searchsorted(bounds, t, side="right") - 1
    return np.where(i >= 0, owner[np.maximum(i, 0)], -1)


def _idle_before(gap_s: np.ndarray, gap_e: np.ndarray, t: np.ndarray):
    """Idle time before each time of ``t``, from the sorted, disjoint idle
    gaps ``[gap_s, gap_e)``."""
    if not len(gap_s):
        return np.zeros(len(t))
    done = np.concatenate([[0.0], np.cumsum(gap_e - gap_s)])
    k = np.searchsorted(gap_s, t, side="right") - 1
    kk = np.maximum(k, 0)
    part = np.clip(t - gap_s[kk], 0.0, gap_e[kk] - gap_s[kk])
    return np.where(k >= 0, done[kk] + part, 0.0)


def program_spans(events: list):
    """({span name: {"n", "host_s", "self_s", "idle_s", "device_s"}}, idle
    seconds inside no program span) of chrome-trace ``events``, over the
    window that ``trace.summarize`` reads, with its device intervals and
    idle gaps (times in us in the trace, seconds out)."""
    from knnbench import trace

    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == trace.WINDOW_SPAN]
    if not win:
        raise ValueError(f"trace has no {trace.WINDOW_SPAN!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in trace.DEVICE_CATS]
    d_start = np.clip(np.array([float(e["ts"]) for e in dev]), w0, w1)
    d_end = np.clip(np.array([float(e["ts"]) + float(e.get("dur", 0.0))
                              for e in dev]), w0, w1)
    m_start, m_end = trace._union(d_start, d_end)
    gap_s = np.concatenate([[w0], m_end])
    gap_e = np.concatenate([m_start, [w1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]

    prog = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in trace.HOST_CATS
            and str(e.get("name", "")).startswith(PROGRAM_PREFIX)
            and w0 <= float(e["ts"]) < w1]
    p_start = np.array([float(e["ts"]) for e in prog])
    p_end = np.minimum(
        p_start + np.array([float(e.get("dur", 0.0)) for e in prog]), w1)
    bounds, owner = _innermost(p_start, p_end)
    n_prog = len(prog)

    def per_span(who, weights):
        keep = who >= 0
        return np.bincount(who[keep], weights=weights[keep],
                           minlength=n_prog)[:n_prog]

    self_us = per_span(owner[:-1], np.diff(bounds))
    idle_us = per_span(owner[:-1],
                       np.diff(_idle_before(gap_s, gap_e, bounds)))
    outside_us = float(np.sum(gap_e - gap_s) - np.sum(idle_us))
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    op_launch = np.array([launched.get(e.get("args", {}).get("correlation"),
                                       np.nan) for e in dev])
    op_owner = _owner_at(bounds, owner, op_launch)
    dev_us = per_span(np.where(np.isnan(op_launch), -1, op_owner),
                      d_end - d_start)
    spans: dict = {}
    for i, e in enumerate(prog):
        row = spans.setdefault(e["name"], {"n": 0, "host_s": 0.0,
                                           "self_s": 0.0, "idle_s": 0.0,
                                           "device_s": 0.0})
        row["n"] += 1
        row["host_s"] += (p_end[i] - p_start[i]) / 1e6
        row["self_s"] += self_us[i] / 1e6
        row["idle_s"] += idle_us[i] / 1e6
        row["device_s"] += dev_us[i] / 1e6
    return spans, outside_us / 1e6


def table_lines(spans: dict, idle_outside_s: float) -> list:
    """One line a span, by name, and the idle time inside none."""
    lines = [f"span {name} n={v['n']} host_s={v['host_s']:.6f} "
             f"self_s={v['self_s']:.6f} idle_s={v['idle_s']:.6f} "
             f"device_s={v['device_s']:.6f}"
             for name, v in sorted(spans.items())]
    lines.append(f"idle_outside_s={idle_outside_s:.6f}")
    return lines


def main(argv=None) -> int:
    """``run.py``'s main with ``--trace 1``, then the span table."""
    sys.path.insert(0, str(ROOT))
    from knnbench import run, trace

    argv = list(sys.argv[1:] if argv is None else argv)
    tables = []
    summarize = trace.summarize

    def summarize_and_keep(events):
        tables.append(program_spans(events))
        return summarize(events)

    trace.summarize = summarize_and_keep
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        trace.summarize = summarize
    for spans, outside in tables:
        for text in table_lines(spans, outside):
            print(text, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
