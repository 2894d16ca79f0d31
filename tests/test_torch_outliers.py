"""The port's statistical outlier removal (``repro_torch.workloads.
statistical_outlier_removal``, PCL's ``StatisticalOutlierRemoval``) held
against its plain reference, ``tests/plain_sor.py`` (a float64 brute self
kNN and the same rule), on the CPU.

Keep bits equal; ``mean_d``, ``mu``, ``sigma`` and ``threshold`` within
1e-5 relative: the port's means are of float32 distances, which read 1.0
to 1.6e-7 relative against exact ones on the card, while a search in
bfloat16 reads 12.7 and above (``PERF.md`` §2), so 1e-5 passes float32
rounding and fails any lower precision.  Planted far points are dropped;
a cloud of at most ``mean_k`` points raises; the filter's span and
counters are recorded.  The search does not depend on ``std_mul``, so a
case at ``std_mul`` 2.0 filters the lists that the same cloud, ``k`` and
backend's search found at 1.0, handed back by a stand-in index.

On a card: the answer bit for bit as the CPU's, and the 2^20-point map of
the ``kitti-sor-k50`` benchmark cell held row by row against the plain
reference (``python -m pytest -q -s tests/test_torch_outliers.py -k
cuda`` prints that comparison's readings)."""

import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_sor
from repro_torch import AllPairsSpec, build_index, make_dataset
from repro_torch.api.index import NeighborIndex
from repro_torch.workloads import OutlierResult, statistical_outlier_removal

torch.set_num_threads(1)

RTOL = 1e-5


def _shells(n=2000, seed=4):
    """Noisy spherical shells of radius 1 with 1% planted far points, 12
    to 20 from the origin, beyond every shell.  Returns the cloud and the
    planted rows."""
    rng = np.random.default_rng(seed)
    n_far = n // 100
    centers = rng.uniform(-5.0, 5.0, size=(4, 3))
    which = rng.integers(0, len(centers), n - n_far)
    v = rng.normal(size=(n - n_far, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    shell = centers[which] + v * (1.0 + rng.normal(0.0, 0.02, (len(v), 1)))
    u = rng.normal(size=(n_far, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    far = u * rng.uniform(12.0, 20.0, (n_far, 1))
    pts = np.concatenate([shell, far]).astype(np.float32)
    return pts, np.arange(n - n_far, n)


SHELLS, PLANTED = _shells()
CLOUDS = {"lidar": make_dataset("kitti", 3000, seed=11), "shells": SHELLS}


@functools.cache
def _plain(cloud, k, std_mul):
    return plain_sor.sor(CLOUDS[cloud], k, std_mul)


@functools.cache
def _filtered(cloud, k, backend):
    """The filter at ``std_mul`` 1.0 through a real index: its search
    runs once for every ``std_mul``."""
    index = build_index(CLOUDS[cloud], backend=backend, device="cpu")
    return statistical_outlier_removal(index, mean_k=k, std_mul=1.0)


class _Replay:
    """An index that answers the one self-query with lists found before."""

    def __init__(self, knn):
        self.knn = knn
        self.n_points = knn.dists.shape[0]

    def query(self, queries, spec):
        assert queries is None and spec == AllPairsSpec(
            self.knn.dists.shape[1])
        return self.knn


@pytest.mark.parametrize("backend", ["trueknn", "brute"])
@pytest.mark.parametrize("std_mul", [1.0, 2.0])
@pytest.mark.parametrize("k", [8, 50])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_filter_equals_plain_reference(cloud, k, std_mul, backend):
    pts = CLOUDS[cloud]
    got = _filtered(cloud, k, backend)
    if std_mul != 1.0:
        got = statistical_outlier_removal(_Replay(got.knn), mean_k=k,
                                          std_mul=std_mul)
    want = _plain(cloud, k, std_mul)
    assert isinstance(got, OutlierResult)
    assert got.keep.dtype == bool and got.mean_d.dtype == np.float32
    assert got.knn.dists.shape == (len(pts), k)
    np.testing.assert_array_equal(got.keep, want.keep)
    np.testing.assert_allclose(got.mean_d, want.mean_d, rtol=RTOL)
    for name in ("mu", "sigma", "threshold"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, err_msg=name)
    assert got.timings["sor_removed"] == int((~got.keep).sum()) > 0
    if cloud == "shells":
        assert not got.keep[PLANTED].any()


def test_plain_reference_imports_torch_and_numpy_only():
    tree = ast.parse(Path(plain_sor.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "dataclasses", "numpy", "torch"}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("n, k", [(50, 50), (30, 50), (8, 8)])
def test_a_cloud_of_at_most_mean_k_points_raises(n, k):
    index = build_index(SHELLS[:n], backend="brute", device="cpu")
    with pytest.raises(ValueError, match="more than mean_k"):
        statistical_outlier_removal(index, mean_k=k)


def test_one_unchunked_self_query_a_span_and_three_counters(monkeypatch):
    calls = []
    real = NeighborIndex.query

    def spy(self, queries, spec=None, **kw):
        calls.append((queries, spec))
        return real(self, queries, spec, **kw)

    monkeypatch.setattr(NeighborIndex, "query", spy)
    index = build_index(SHELLS[:600], backend="brute", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = statistical_outlier_removal(index, mean_k=8, std_mul=2.0)
    assert calls == [(None, AllPairsSpec(8))]
    names = [e.name for e in prof.events()]
    assert names.count("repro_torch.sor.filter") == 1
    t = got.timings
    assert t is not got.knn.timings
    assert {k: t[k] for k in got.knn.timings} == got.knn.timings
    assert 0.0 < t["sor_filter_seconds"] < 60.0
    assert t["sor_removed"] == int((~got.keep).sum())
    assert t["sor_threshold"] == got.threshold
    # outside a profiler the same call answers alike
    again = statistical_outlier_removal(index, mean_k=8, std_mul=2.0)
    np.testing.assert_array_equal(again.keep, got.keep)
    np.testing.assert_array_equal(again.mean_d, got.mean_d)


needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card")


@needs_card
@pytest.mark.parametrize("k", [8, 50])
def test_cuda_filter_equals_cpu(k):
    """On the card: the same answer bit for bit as the CPU's plain
    versions."""
    pts = CLOUDS["lidar"]
    cpu = _filtered("lidar", k, "trueknn")
    got = statistical_outlier_removal(
        build_index(pts, backend="trueknn", device="cuda"), mean_k=k)
    for name in ("keep", "mean_d"):
        np.testing.assert_array_equal(getattr(got, name), getattr(cpu, name))
    np.testing.assert_array_equal(got.knn.dists, cpu.knn.dists)
    np.testing.assert_array_equal(got.knn.idxs, cpu.knn.idxs)
    assert got.threshold == cpu.threshold


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


#: the seed from which the ``kitti-sor-k50`` cell draws its map
#: (``knnbench.datagen.derive_seed(0, "cloud")`` for its ``cloud_seed`` 0)
CELL_MAP_SEED = 1895919012411226994


def whole_map(n: int, device: str, k: int = 50, std_mul: float = 1.0):
    """The filter of an n-point ``lidar_like`` map (at n = 2^20 the map of
    the ``kitti-sor-k50`` cell) on a trueknn index on ``device``, called
    twice as a benchmark batch is, against the plain reference run in
    blocks on the same device.  Returns the readings and both answers."""
    pts = make_dataset("kitti", n, seed=CELL_MAP_SEED)
    index = build_index(pts, backend="trueknn", device=device)
    for _ in range(2):
        got = statistical_outlier_removal(index, mean_k=k, std_mul=std_mul)
    del index
    want = plain_sor.sor(pts, k, std_mul, block=2048, device=device)
    m = got.mean_d.astype(np.float64)
    near = np.abs(m - got.threshold) <= RTOL * abs(got.threshold)
    differ = np.flatnonzero(got.keep != want.keep)
    readings = {
        "n_points": n, "k": k, "std_mul": std_mul,
        "removed": int((~got.keep).sum()),
        "removed_plain": int((~want.keep).sum()),
        "keep_differ_rows": differ.tolist(),
        "rows_within_1e-5_of_threshold": np.flatnonzero(near).tolist(),
        "mean_d_rel_gap": _rel(m, want.mean_d),
        "mu_rel_gap": _rel(got.mu, want.mu),
        "sigma_rel_gap": _rel(got.sigma, want.sigma),
        "threshold_rel_gap": _rel(got.threshold, want.threshold),
        "mu": got.mu, "sigma": got.sigma, "threshold": got.threshold,
        "rounds": len(got.knn.rounds),
        "sor_filter_seconds": got.timings["sor_filter_seconds"],
    }
    return readings, got, want


def _hold_whole_map(readings):
    assert set(readings["keep_differ_rows"]) <= set(
        readings["rows_within_1e-5_of_threshold"]), readings
    for name in ("mean_d", "mu", "sigma", "threshold"):
        assert readings[f"{name}_rel_gap"] <= RTOL, (name, readings)
    assert readings["removed"] > 0


def test_whole_map_comparison_on_a_small_map():
    """The card case's comparison, on the CPU at a small size."""
    readings, got, _ = whole_map(1000, "cpu", k=8)
    _hold_whole_map(readings)
    assert readings["keep_differ_rows"] == []
    assert readings["removed"] == int((~got.keep).sum())


@needs_card
def test_cuda_whole_map_equals_plain_reference():
    """Every row of the benchmark's 2^20-point map at k = 50: keep bits
    equal to the plain reference's, or differing only on rows within
    1e-5 of the threshold; ``mean_d``, ``mu``, ``sigma`` and
    ``threshold`` within 1e-5 relative."""
    readings, _, _ = whole_map(1 << 20, "cuda")
    readings["device"] = torch.cuda.get_device_name(0)
    print("whole_map " + json.dumps(readings))
    _hold_whole_map(readings)
