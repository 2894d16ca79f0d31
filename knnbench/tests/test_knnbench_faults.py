"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``drivers.run_cell`` on the CPU, where the program runs its plain
versions) at a size a test holds, with one fault planted where the
answers are produced: a neighbour altered, or half of the batch left
out.  A sound run at the same size comes out correct.  The size is the
``cpu_test`` groups of the cell's configuration and traffic files."""

import numpy as np
import pytest

from knnbench import compare, drivers, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_cell_has_a_test_size():
    for name in CELLS:
        cell = spec.resolve_cell(BENCH, name)
        assert int(cell.cpu_test["n_points"]) > cell.config["k"], name


def _run(cell_name, seconds=0.6):
    cell = spec.resolve_cell(BENCH, cell_name)
    rec = drivers.run_cell(cell, 2**31 + 77, seconds, False, device="cpu",
                           sizes=cell.cpu_test)
    return rec, compare.judge(rec.checks)


def _break_fused(monkeypatch, fault):
    import repro_torch.api.backends.trueknn as tk

    real = tk.fused_search

    def broken(*a, **kw):
        fr = real(*a, **kw)
        n = len(fr.dists)
        if fault == "altered":
            # one neighbour of every row replaced by another point
            fr.idxs[:, -1] = (fr.idxs[:, -1] + 1) % a[0].shape[0]
        elif fault == "half_left_out":
            fr.dists[n // 2:] = np.inf
            fr.idxs[n // 2:] = a[0].shape[0]
        return fr

    monkeypatch.setattr(tk, "fused_search", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rec, ok = _run(cell)
    assert ok, rec.checks
    assert rec.rows_checked > 0


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_answers_are_not_correct(cell, fault, monkeypatch):
    _break_fused(monkeypatch, fault)
    rec, ok = _run(cell)
    assert not ok, rec.checks
