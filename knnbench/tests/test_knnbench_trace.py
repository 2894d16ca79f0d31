"""The reduction of a profiler trace: busy seconds as a union of device
intervals inside the window, device time by name, idle gaps named after
the host event that was running."""

import pytest

from knnbench import trace


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_summarize_unions_and_names_gaps():
    events = [
        _x(trace.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
        _x("kern_a", "kernel", 900.0, 200.0),      # clipped to 1000-1100
        _x("kern_b", "kernel", 1050.0, 100.0),     # overlaps a: 1000-1150
        _x("Memcpy DtoH", "gpu_memcpy", 1400.0, 100.0),
        _x("kern_a", "kernel", 1900.0, 300.0),     # clipped to 1900-2000
        _x("host_probe", "cpu_op", 1100.0, 400.0),  # covers gap 1150-1400
        _x("knnbench.batch", "user_annotation", 1000.0, 1000.0),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((150 + 100 + 100) * 1e-6)
    assert s.device_s["kern_a"] == pytest.approx(200e-6)
    assert s.kernel_seconds("kern") == pytest.approx(300e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["host_probe"] == pytest.approx(250e-6)
    assert gaps["knnbench.batch"] == pytest.approx(400e-6)
    assert s.device_ops[0][0] == "kern_a"


def test_summarize_needs_the_window():
    with pytest.raises(ValueError):
        trace.summarize([_x("k", "kernel", 0.0, 1.0)])
