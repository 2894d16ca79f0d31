"""The table of the program's spans in a traced run: how often each ran,
its host, self, idle and device seconds, and the idle time inside none;
and the tool that prints it beside run.py's result line."""

import os
import subprocess
import sys

import pytest

from knnbench import run, span_table, trace
from knnbench.spec import ROOT


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(name, ts, corr):
    return {"ph": "X", "name": name, "cat": "cuda_runtime", "ts": ts,
            "dur": 5.0, "tid": 1, "args": {"correlation": corr}}


def _op(name, cat, ts, dur, corr):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


#: a window of 1000 us; one query with nested program spans, a launch in
#: each; busy 60 + 490 + 30 us, idle 420 us
PROGRAM = [
    _x("repro_torch.query", "user_annotation", 1000.0, 820.0),
    _x("repro_torch.fused.upload", "user_annotation", 1010.0, 90.0),
    _x("repro_torch.fused.round", "user_annotation", 1100.0, 200.0),
    _x("repro_torch.fused.round", "user_annotation", 1300.0, 200.0),
    _x("repro_torch.fused.fetch", "user_annotation", 1500.0, 250.0),
    _x("repro_torch.fused.round", "gpu_user_annotation", 1160.0, 440.0, 7),
]
DEVICE = [
    _x(trace.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
    _x("knnbench.batch", "user_annotation", 1000.0, 950.0),
    _x("aten::sort", "cpu_op", 1115.0, 50.0),
    _launch("cudaMemcpyAsync", 1050.0, 1),
    _op("Memcpy HtoD", "gpu_memcpy", 1060.0, 60.0, 1),
    _launch("cudaLaunchKernel", 1150.0, 2),
    _op("grid_round_a", "kernel", 1160.0, 240.0, 2),
    _launch("cudaLaunchKernel", 1350.0, 3),
    _op("grid_round_b", "kernel", 1400.0, 200.0, 3),
    _launch("cudaMemcpyAsync", 1550.0, 4),
    _op("Memcpy DtoH", "gpu_memcpy", 1600.0, 50.0, 4),
    _launch("cudaLaunchKernel", 1900.0, 5),      # in no program span
    _op("other", "kernel", 1950.0, 30.0, 5),
]


def test_program_spans_sum_by_name():
    sp, outside = span_table.program_spans(DEVICE + PROGRAM)
    assert set(sp) == {"repro_torch.query", "repro_torch.fused.upload",
                       "repro_torch.fused.round", "repro_torch.fused.fetch"}
    # idle gaps 1000-1060, 1120-1160, 1650-1950 and 1980-2000, each
    # stretch of one counted in the innermost program span running then
    want = {  # n, host, self, idle, device
        "repro_torch.query": (1, 820, 80, 10 + 70, 0),
        "repro_torch.fused.upload": (1, 90, 90, 50, 60),
        "repro_torch.fused.round": (2, 400, 400, 40, 440),
        "repro_torch.fused.fetch": (1, 250, 250, 100, 50),
    }
    for name, (n, host, own, idle, dev) in want.items():
        assert sp[name]["n"] == n, name
        assert sp[name]["host_s"] == pytest.approx(host * 1e-6), name
        assert sp[name]["self_s"] == pytest.approx(own * 1e-6), name
        assert sp[name]["idle_s"] == pytest.approx(idle * 1e-6), name
        assert sp[name]["device_s"] == pytest.approx(dev * 1e-6), name
    assert outside == pytest.approx((130 + 20) * 1e-6)


@pytest.mark.parametrize("events", [DEVICE + PROGRAM, DEVICE])
def test_program_idle_and_outside_add_up_to_the_window(events):
    sp, outside = span_table.program_spans(events)
    s = trace.summarize(events)
    idle = sum(v["idle_s"] for v in sp.values()) + outside
    assert abs(idle - (s.window_s - s.busy_s)) < 1e-9


def test_program_spans_leave_the_device_figures_as_they_were():
    with_spans = trace.summarize(DEVICE + PROGRAM)
    without = trace.summarize(DEVICE)
    assert span_table.program_spans(DEVICE)[0] == {}
    for field in ("window_s", "busy_s", "device_s", "device_ops"):
        assert getattr(with_spans, field) == getattr(without, field), field


def test_gpu_user_annotation_is_no_program_span():
    sp, outside = span_table.program_spans([
        _x(trace.WINDOW_SPAN, "user_annotation", 0.0, 100.0),
        _x("repro_torch.fused.round", "gpu_user_annotation", 10.0, 50.0, 7),
    ])
    assert sp == {}  # a device-side copy of a span is not a host span
    assert outside == pytest.approx(100e-6)


def test_program_spans_need_the_window():
    with pytest.raises(ValueError):
        span_table.program_spans(PROGRAM)


def test_table_lines():
    sp, outside = span_table.program_spans(DEVICE + PROGRAM)
    lines = span_table.table_lines(sp, outside)
    assert len(lines) == len(sp) + 1
    assert lines[0].startswith("span repro_torch.fused.fetch n=1 ")
    assert lines[-1] == "idle_outside_s=0.000150"


def test_main_traces_and_prints_the_table(monkeypatch, capsys):
    """main runs run.py's main with --trace 1, keeps the table of the
    trace that run.py reduces, and puts trace.summarize back."""
    seen = []

    def fake_main(argv):
        seen.append(argv)
        trace.summarize(DEVICE + PROGRAM)
        return 0

    summarize = trace.summarize
    monkeypatch.setattr(run, "main", fake_main)
    assert span_table.main(["--workload", "w", "--seed", "5",
                            "--seconds", "1"]) == 0
    assert seen[0][-2:] == ["--trace", "1"]
    assert trace.summarize is summarize
    err = capsys.readouterr().err.splitlines()
    assert "span repro_torch.fused.round n=2 " in err[1]
    assert err[-1] == "idle_outside_s=0.000150"


def test_span_table_fails_without_a_card():
    p = subprocess.run(
        [sys.executable, "knnbench/span_table.py", "--workload",
         "kitti-scan2map", "--seed", str(2**31 + 3), "--seconds", "1"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "CUDA card" in p.stderr
