"""``kitti-sor-k50``: PCL's statistical outlier removal as a cell.

Whole runs at the cell's CPU test size (``drivers.run_cell`` on the CPU,
where the program runs its plain versions): a sound run reads correct
with nothing failed, and its ``sor.filter_s`` reads; a keep bit flipped
in the workload's result, or means worked out in bfloat16, count as
failed and read not correct; a neighbour altered reads not correct.  The
filter's rule (``sor_reference.bad_rows``) on arrays made here: each kind
of disagreement counts the rows it should.  A run writes nothing into
the harness."""

import hashlib

import numpy as np
import pytest
import torch

from knnbench import compare, datagen, drivers, sor_reference, spec
from knnbench.run import result_line
from knnbench.tests.test_knnbench_imports import _top_names

torch.set_num_threads(1)

BENCH = spec.load_benchmark()
CELL = "kitti-sor-k50"


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _run(seed):
    cell = spec.resolve_cell(BENCH, CELL)
    rec = drivers.run_cell(cell, seed, 0.05, False, device="cpu",
                           sizes=cell.cpu_test)
    return cell, rec


def _patch_result(monkeypatch, fault):
    import repro_torch.workloads as workloads

    real = workloads.statistical_outlier_removal

    def patched(index, *a, **kw):
        res = real(index, *a, **kw)
        if fault == "flipped_keep":
            res.keep[7] = not res.keep[7]
        elif fault == "bf16_means":
            # every mean in bfloat16, the threshold and the decisions
            # worked out from those means as the rule says: only the
            # means, against their own lists, give the fault away
            k = res.knn.dists.shape[1]
            lists = torch.from_numpy(res.knn.dists).bfloat16().float()
            res.mean_d = (lists.sum(1) / k).bfloat16().float().numpy()
            res.threshold = sor_reference.threshold(res.mean_d, 1.0)
            res.keep = res.mean_d.astype(np.float64) <= res.threshold
        elif fault == "altered":
            # one neighbour of every row replaced by another point
            res.knn.idxs[:, -1] = (res.knn.idxs[:, -1] + 1) % index.n_points
        return res

    monkeypatch.setattr(workloads, "statistical_outlier_removal", patched)


def test_the_cell_is_pcl_at_its_tutorial_parameters():
    cell = spec.resolve_cell(BENCH, CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "sor_filter"
    assert (cell.config["k"], cell.config["std_mul"]) == (50, 1.0)
    assert cell.config["n_points"] == 1 << 20
    assert cell.config["dataset"] == "lidar_like"
    assert cell.config["cloud_seed"] == 0
    layer = {m["name"] for m in cell.per_layer}
    assert {"sor.filter_s", "grid_round_roofline", "search.rounds"} <= layer


def test_the_card_case_of_the_filter_draws_this_cells_map():
    """``tests/test_torch_outliers.py``'s whole-map case draws the cell's
    map with the program's generator from this seed."""
    from repro_torch import make_dataset

    cell = spec.resolve_cell(BENCH, CELL)
    want = datagen.make_cloud({**cell.config, "n_points": 4096})
    got = make_dataset("kitti", 4096, seed=1895919012411226994)
    np.testing.assert_array_equal(got, want)


def test_the_rule_imports_nothing_of_the_program():
    assert _top_names(spec.HERE / "sor_reference.py") <= {"numpy",
                                                          "__future__"}


def test_sound_run_is_correct_with_nothing_failed():
    before = _digests(spec.HERE)
    cell, rec = _run(2**31 + 29)
    assert compare.judge(rec.checks), rec.checks
    assert rec.failed == 0 and rec.batches and rec.rows_checked > 0
    assert rec.k == 50 and rec.attempted == rec.n_points * len(rec.batches)
    e2e = result_line(rec, cell, False, "cpu")
    assert e2e["correct"] and e2e["failed"] == 0
    assert {"knn_qps", "setup_s"} <= set(e2e["metrics"])
    layer = result_line(rec, cell, True, "cpu")["metrics"]
    want = np.mean([b["timings"]["sor_filter_seconds"] for b in rec.batches])
    assert layer["sor.filter_s"] == {"value": want, "unit": "s"}
    assert {"search.rounds", "search.rounds_launched",
            "grid.probe_passes"} <= set(layer)
    assert _digests(spec.HERE) == before


@pytest.mark.parametrize("fault", ["flipped_keep", "bf16_means"])
def test_a_broken_filter_counts_as_failed_and_is_not_correct(monkeypatch,
                                                             fault):
    _patch_result(monkeypatch, fault)
    cell, rec = _run(2**32 + 3)
    assert not compare.judge(rec.checks), rec.checks
    assert rec.checks["dist_rel_err"] == float("inf")
    if fault == "flipped_keep":
        assert rec.failed == len(rec.batches) >= 1
    else:
        # the sampled rows of every batch
        assert rec.failed >= 0.99 * rec.rows_checked > 0
    line = result_line(rec, cell, False, "cpu")
    assert not line["correct"] and line["failed"] == rec.failed


def test_an_altered_neighbour_is_not_correct(monkeypatch):
    _patch_result(monkeypatch, "altered")
    _, rec = _run(2**32 + 5)
    assert not compare.judge(rec.checks), rec.checks


def _batch(n=400, k=6, seed=0, std_mul=1.0):
    rng = np.random.default_rng(seed)
    dists = np.sort(rng.gamma(2.0, 0.5, (n, k)).astype(np.float32), axis=1)
    mean_d = (dists.sum(1, dtype=np.float64) / k).astype(np.float32)
    thr = sor_reference.threshold(mean_d, std_mul)
    keep = mean_d.astype(np.float64) <= thr
    rows = rng.choice(n, size=n // 4, replace=False)
    return keep, mean_d, thr, rows, dists


@pytest.mark.parametrize("fault, want", [
    ("none", 0),
    ("flipped_keep", 1),
    ("threshold_off_2e-9", 400),
    ("threshold_nan", 400),
    ("threshold_float32", 400),
    ("threshold_population_std", 400),
    ("one_mean_moved_2e-6", 400),
])
def test_the_rule_counts_the_rows_that_break_it(fault, want):
    keep, mean_d, thr, rows, dists = _batch()
    std_mul = 1.0
    if fault == "flipped_keep":
        keep[rows[3]] = not keep[rows[3]]
    elif fault == "threshold_off_2e-9":
        thr *= 1 + 2e-9
    elif fault == "threshold_nan":
        thr = float("nan")
    elif fault == "threshold_float32":
        thr = float(np.float32(thr))
    elif fault == "threshold_population_std":
        m = mean_d.astype(np.float64)
        thr = float(m.mean() + std_mul * m.std(ddof=0))
    elif fault == "one_mean_moved_2e-6":
        # a mean moved under the returned threshold: the rule's threshold,
        # from the returned means, no longer matches it
        mean_d[rows[0]] *= np.float32(1 + 2e-6)
    bad = sor_reference.bad_rows(keep, mean_d, thr, std_mul,
                                 rows, dists[rows])
    assert int(bad.sum()) == want


def test_a_sampled_mean_off_its_own_list_counts():
    keep, mean_d, thr, rows, dists = _batch()
    # the list moved under a sampled row: its mean no longer follows it
    lists = dists[rows].copy()
    lists[5] *= np.float32(1 + 4e-6)
    bad = sor_reference.bad_rows(keep, mean_d, thr, 1.0, rows, lists)
    assert np.flatnonzero(bad).tolist() == [rows[5]]
    lists[5] = dists[rows[5]] * np.float32(1 + 2e-7)
    assert not sor_reference.bad_rows(keep, mean_d, thr, 1.0, rows,
                                      lists).any()
