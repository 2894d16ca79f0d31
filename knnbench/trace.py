"""The traced run: a ``torch.profiler`` trace of the measured window, and
its reduction to what the per-layer readers and the result line need.

The driver marks the window with a ``knnbench.window`` span.  From the
trace's device events (kernels, copies, sets) clipped to that span come
the device's busy seconds (the union of their intervals), the seconds of
each device operation by name, and the idle gaps, each named after the
innermost host event that was running at its midpoint.  The trace is
written to ``TMPDIR``, read once and deleted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import numpy as np

__all__ = ["WINDOW_SPAN", "TraceSummary", "traced", "summarize", "span"]

WINDOW_SPAN = "knnbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: idle gaps named one by one (the longest); shorter ones are summed
NAMED_GAPS = 4000
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: dict  # device op name -> seconds inside the window
    device_ops: list  # [[name, seconds], ...] the TOP longest in all
    idle_gaps: list  # [[host activity, seconds], ...] the TOP longest
    trace_bytes: int = 0  # size of the exported trace file

    def kernel_seconds(self, needle: str) -> float:
        """Seconds of the device ops whose name holds ``needle``."""
        return sum(s for name, s in self.device_s.items() if needle in name)


def span(name: str):
    """A named host span in the trace (a no-op cost when not tracing)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def traced(enabled: bool, out: list):
    """Profile the body when ``enabled`` and append its ``TraceSummary`` to
    ``out``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield
    fd, path = tempfile.mkstemp(prefix="knnbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out.append(dataclasses.replace(summarize(events), trace_bytes=size))


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged, sorted intervals of the given ones."""
    if not len(starts):
        return np.empty(0), np.empty(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_start = s[idx]
    m_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    return m_start, m_end


def summarize(events: list) -> TraceSummary:
    """Reduce chrome-trace events to a ``TraceSummary`` (times in us in the
    trace, seconds out)."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError(f"trace has no {WINDOW_SPAN!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    starts = np.clip(np.array([float(e["ts"]) for e in dev]), w0, w1)
    ends = np.clip(np.array([float(e["ts"]) + float(e.get("dur", 0.0))
                             for e in dev]), w0, w1)
    device_s: dict = {}
    for e, s, t in zip(dev, starts, ends):
        if t > s:
            device_s[e["name"]] = device_s.get(e["name"], 0.0) + (t - s) / 1e6
    m_start, m_end = _union(starts, ends)
    busy_us = float(np.sum(m_end - m_start)) if len(m_start) else 0.0

    # idle gaps between the merged device intervals, window edges included
    gap_s = np.concatenate([[w0], m_end])
    gap_e = np.concatenate([m_start, [w1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN]
    h_start = np.array([float(e["ts"]) for e in host])
    h_end = h_start + np.array([float(e.get("dur", 0.0)) for e in host])
    h_len = h_end - h_start
    named: dict = {}
    order = np.argsort(gap_e - gap_s)[::-1]
    for n, g in enumerate(order):
        length = (gap_e[g] - gap_s[g]) / 1e6
        if n >= NAMED_GAPS:
            key = f"(shorter gaps than the {NAMED_GAPS} longest)"
        else:
            mid = 0.5 * (gap_s[g] + gap_e[g])
            inside = np.flatnonzero((h_start <= mid) & (h_end >= mid))
            key = ("(no host event)" if not len(inside)
                   else host[inside[np.argmin(h_len[inside])]]["name"])
        named[key] = named.get(key, 0.0) + length
    top_ops = sorted(device_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy_us / 1e6,
        device_s=device_s,
        device_ops=[[name, s] for name, s in top_ops],
        idle_gaps=[[name, s] for name, s in top_gaps],
    )
