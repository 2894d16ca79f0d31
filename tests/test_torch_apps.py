"""The port's applications against the JAX package's: the oracle radii
(``max_knn_distance``, ``percentile_knn_distance``), the kNN-LM
datastore (``repro_torch.core.knnlm``, carried across with
``convert.datastore_from_reference``) and the serving launcher
(``repro_torch.launch.serve``), whose printed counts must equal the
reference launcher's on the same flags (times are not compared)."""

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro.core.knnlm as ref_knnlm
import repro_torch.core as port_core
import repro_torch.core.knnlm as port_knnlm
from repro_torch import HybridSpec, KnnSpec
from repro_torch.convert import datastore_from_reference
from repro_torch.launch import serve as port_serve

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
#: knn_logprobs: the weights' exp and the scatter's summation order may
#: differ from numpy's by a rounding
LOGPROB_ATOL = 1e-6


# -- the oracle radii --------------------------------------------------------


@pytest.mark.parametrize("dataset,n,k", [("kitti", 700, 8), ("porto", 600, 4),
                                         ("uniform", 500, 1)])
def test_max_knn_distance_equals_reference(dataset, n, k):
    pts = port_core.make_dataset(dataset, n, seed=5)
    want = ref_core.max_knn_distance(pts, k)
    assert port_core.max_knn_distance(pts, k, device="cpu") == want
    assert port_core.max_knn_distance(pts, k, chunk=64, device="cpu") == want


@pytest.mark.parametrize("dataset,n,k,pct", [("kitti", 700, 8, 99.0),
                                             ("porto", 600, 4, 50.0),
                                             ("uniform", 500, 2, 90.0)])
def test_percentile_knn_distance_equals_reference(dataset, n, k, pct):
    pts = port_core.make_dataset(dataset, n, seed=6)
    want = ref_core.percentile_knn_distance(pts, k, pct)
    assert port_core.percentile_knn_distance(pts, k, pct,
                                             device="cpu") == want


def test_oracle_radii_search_a_tensor_on_its_own_device():
    pts = port_core.make_dataset("kitti", 300, seed=1)
    t = torch.from_numpy(pts)
    assert port_core.max_knn_distance(t, 4) == ref_core.max_knn_distance(
        pts, 4)  # the "cuda" default does not apply to a tensor
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_core.max_knn_distance(pts, 4)


def test_core_exports_match_the_reference():
    want = set(ref_core.__all__)
    assert want <= set(port_core.__all__)
    for name in want:
        assert getattr(port_core, name) is not None, name
    assert port_core.build_index is port_core.__getattr__("build_index")
    assert port_core.TrueKNNResult is port_core.KNNResult
    with pytest.raises(AttributeError):
        port_core.no_such_name


def test_launch_exports_match_the_reference():
    import repro.launch as ref_launch
    import repro_torch.launch as port_launch

    assert port_launch.__all__ == ref_launch.__all__
    for name in port_launch.__all__:
        assert callable(getattr(port_launch, name)), name
    # the package never imports dryrun itself (it is an entry module)
    tree = ast.parse(Path(port_launch.__file__).read_text())
    imported = [a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names] + [n.module or "" for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)]
    assert not any("dryrun" in name for name in imported), imported


# -- the kNN-LM datastore ----------------------------------------------------


def _stores(hid, tgt):
    ref = ref_knnlm.build_datastore(hid, tgt)
    port = datastore_from_reference(
        ref.keys3d, ref.targets, ref.projector.mean,
        ref.projector.components, backend="trueknn", device="cpu")
    return ref, port


def test_build_datastore_keys_equal_reference():
    rng = np.random.default_rng(4)
    hid = rng.normal(size=(900, 24)).astype(np.float32)
    tgt = rng.integers(0, 40, 900).astype(np.int32)
    ref = ref_knnlm.build_datastore(hid, tgt)
    port = port_knnlm.build_datastore(hid, tgt, device="cpu")
    for a, b in ((port.keys3d, ref.keys3d),
                 (port.projector.mean, ref.projector.mean),
                 (port.projector.components, ref.projector.components),
                 (port.targets, ref.targets)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.index.device.type == "cpu"
    q = rng.normal(size=(8, 24)).astype(np.float32)
    assert np.array_equal(port.projector(q), ref.projector(q))


def test_knnlm_datastore_holds_resident_index():
    rng = np.random.default_rng(0)
    hid = rng.normal(size=(1200, 16)).astype(np.float32)
    tgt = rng.integers(0, 50, 1200).astype(np.int32)
    ref, store = _stores(hid, tgt)
    assert isinstance(store.index, port_core.NeighborIndex)
    assert store.index.n_points == 1200
    p1 = port_knnlm.knn_logprobs(store, hid[:32], 50, k=4)
    p2 = port_knnlm.knn_logprobs(store, hid[32:64], 50, k=4)
    assert p1.shape == (32, 50) and p1.dtype == np.float32
    np.testing.assert_allclose(p1.sum(1), 1.0, rtol=1e-4)
    assert store.index.stats()["batches"] == 2
    assert store.index.stats()["grid_builds"] > 0
    np.testing.assert_allclose(
        p1, ref_knnlm.knn_logprobs(ref, hid[:32], 50, k=4), rtol=0,
        atol=LOGPROB_ATOL)
    np.testing.assert_allclose(
        p2, ref_knnlm.knn_logprobs(ref, hid[32:64], 50, k=4), rtol=0,
        atol=LOGPROB_ATOL)


def test_knnlm_retrieval_improves_seen_data():
    rng = np.random.default_rng(0)
    n, dim, vocab = 2000, 32, 64
    hid = rng.normal(size=(n, dim)).astype(np.float32)
    tgt = rng.integers(0, vocab, n).astype(np.int32)
    ref, store = _stores(hid, tgt)
    q = hid[:100]
    p_knn = port_knnlm.knn_logprobs(store, q, vocab, k=4)
    np.testing.assert_allclose(
        p_knn, ref_knnlm.knn_logprobs(ref, q, vocab, k=4), rtol=0,
        atol=LOGPROB_ATOL)
    acc = (p_knn.argmax(1) == tgt[:100]).mean()
    assert acc > 0.5, acc
    p_lm = np.full((100, vocab), 1.0 / vocab, np.float32)
    nll_lm = -np.log(p_lm[np.arange(100), tgt[:100]]).mean()
    p_mix = port_knnlm.interpolate(p_lm, p_knn, 0.5)
    assert np.array_equal(p_mix, ref_knnlm.interpolate(p_lm, p_knn, 0.5))
    nll_mix = -np.log(np.clip(p_mix[np.arange(100), tgt[:100]], 1e-9,
                              None)).mean()
    assert nll_mix < nll_lm


def test_pca_projector_orthonormal():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    proj = port_knnlm.fit_pca(x)
    ref = ref_knnlm.fit_pca(x)
    assert np.array_equal(proj.components, ref.components)
    assert np.array_equal(proj.mean, ref.mean)
    g = proj.components.T @ proj.components
    np.testing.assert_allclose(g, np.eye(3), atol=1e-4)


@pytest.mark.parametrize("kw", [{"max_dist": 0.4}, {"metric": "cosine"},
                                {"temperature": 0.05, "k": 8}])
def test_knn_logprobs_options_match_reference(kw):
    """HybridSpec retrieval (far matches dropped), cosine retrieval and a
    sharp temperature, through the same datastore on both packages."""
    rng = np.random.default_rng(9)
    hid = rng.normal(size=(800, 12)).astype(np.float32)
    tgt = rng.integers(0, 30, 800).astype(np.int32)
    ref, store = _stores(hid, tgt)
    q = hid[:40] + rng.normal(scale=0.1, size=(40, 12)).astype(np.float32)
    got = port_knnlm.knn_logprobs(store, q, 30, **kw)
    want = ref_knnlm.knn_logprobs(ref, q, 30, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGPROB_ATOL)
    # the retrieval itself is the reference's, bitwise
    k, metric = kw.get("k", 8), kw.get("metric", "l2")
    spec = (KnnSpec(k), ref_api.KnnSpec(k)) if "max_dist" not in kw else (
        HybridSpec(k, kw["max_dist"]), ref_api.HybridSpec(k, kw["max_dist"]))
    a = store.index.query(store.projector(q), spec[0], metric=metric)
    b = ref.index.query(ref.projector(q), spec[1], metric=metric)
    assert np.array_equal(a.dists, b.dists) and np.array_equal(a.idxs, b.idxs)


# -- the launcher ------------------------------------------------------------


def _port_run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_serve.main(argv)
    return out.getvalue()


def _ref_run(argv, monkeypatch):
    from repro.launch import serve as ref_serve

    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(out):
        ref_serve.main()
    return out.getvalue()


def _ref_subprocess(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve"] + argv,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


_COUNTS = [
    r"(plan=\S+ dropped_partial=\d+ dropped_empty=\d+)",
    r"(plan=\S+ nnz=\d+ rows_max=\d+)",
    r"open loop: (\d+/\d+) requests served",
    r"(dropped_partial=\d+)$",
    r"bucket (\S+): (\d+) reqs in",
    r"(rows/batch, hist \{[^}]*\})",
    r"(admission control shed \d+ requests)",
    r"(kNN graph \(k=\d+, symmetrize='\w+'\): \d+ nodes, \d+ edges)",
    r"(degree min \d+ median \d+ max \d+; generation \d+)",
    r"(using warm median [\d.]+)",
    r"(DBSCAN\(eps=[\d.]+, min_pts=\d+\): \d+ clusters, \d+ core points, "
    r"\d+ noise of \d+)",
    r"(largest cluster \d+ rows)",
    r"(workload meter: .*)$",
    r"(placement '\w+': \d+ slots on \d+ devices, occupancy \[[^]]*\], "
    r"\d+ fused dispatches, \d+ rebalances)",
    r"(\d+ shards \(sizes \[[^]]*\]\), prune_rate [\d.]+ \(\d+ of \d+ "
    r"visits skipped\))",
]


def _counts(text, timed_batches=False):
    """Every count the launcher prints, in order, without its times."""
    got = []
    for line in text.splitlines():
        for pat in _COUNTS:
            if timed_batches and "hist" in pat:
                continue
            got += [m.groups() for m in re.finditer(pat, line)]
    assert got, text
    return got


def _plan_trees(text):
    """The JSON ``--explain`` prints after its header line."""
    lines = text.splitlines()
    start = lines.index("active plan trees (per tenant):") + 1
    end = lines.index("}", start)
    return json.loads("\n".join(lines[start:end + 1]))


FLAGS = {
    "knn-closed": ["--mode", "knn", "--n", "2000", "--batches", "3",
                   "--batch-size", "64", "--arrival", "closed", "--spec",
                   "hybrid", "--k", "5", "--explain"],
    "knn-open": ["--mode", "knn", "--n", "2000", "--batches", "2",
                 "--batch-size", "32", "--arrival", "open", "--rate",
                 "2000"],
    "knn-range": ["--mode", "knn", "--n", "1500", "--batches", "2",
                  "--batch-size", "32", "--spec", "range", "--metric", "l1",
                  "--backend", "sharded", "--shards", "3"],
    "graph": ["--mode", "graph", "--n", "1500", "--k", "6", "--backend",
              "brute", "--symmetrize", "mutual"],
    "dbscan": ["--mode", "dbscan", "--n", "1500", "--min-pts", "6",
               "--backend", "trueknn"],
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_launcher_counts_equal_reference(case, monkeypatch):
    argv = FLAGS[case]
    got = _port_run(argv + ["--device", "cpu"])
    want = _ref_run(argv, monkeypatch)
    timed = case == "knn-open"  # batch composition follows arrival times
    assert _counts(got, timed) == _counts(want, timed)
    if "--explain" in argv:
        assert _plan_trees(got) == _plan_trees(want)


def test_launcher_placed_sharded_equals_reference():
    """``--placement devices --devices 2``: the reference forces two host
    devices in its own process; the port serves on a 2-position CPU mesh.
    Placement, occupancy and dispatch counts are equal."""
    argv = ["--mode", "knn", "--backend", "sharded", "--shards", "5",
            "--placement", "devices", "--devices", "2", "--n", "1200",
            "--batches", "2", "--batch-size", "64", "--arrival", "closed",
            "--spec", "hybrid", "--k", "4"]
    got = _port_run(argv + ["--device", "cpu"])
    assert "mesh: 2 positions over 1 device(s) ['cpu']" in got
    want = _ref_subprocess(argv)
    assert "forced host platform devices: 2" in want
    assert _counts(got) == _counts(want)
    assert "2 devices" in got and "/placed=1" in got


def test_launcher_mutating_tenant_serves_without_errors():
    out = _port_run(["--mode", "knn", "--n", "1500", "--batches", "2",
                     "--batch-size", "32", "--arrival", "open", "--rate",
                     "1000", "--mutate", "200", "--device", "cpu"])
    for mode in ("background", "off"):
        assert f"auto_compact={mode!r}" in out
    writes = re.findall(r"writes: \+(\d+) rows, -(\d+) rows \((\d+) errors\)",
                        out)
    assert len(writes) == 2 and all(w[2] == "0" for w in writes), out
    assert out.count("open loop: 64/64 requests served") == 2


def test_launcher_lm_mode_equals_reference(monkeypatch):
    """``--mode lm``: the reference launcher serves the arch's smoke
    config with ``init_params(PRNGKey(0))``; the port's, given the same
    weights through ``convert.lm_params_from_reference``, prints the same
    request and token counts and the same sample completion."""
    import jax

    from repro.configs import get_config, smoke_config
    from repro.models import init_params
    from repro_torch.convert import lm_params_from_reference

    argv = ["--mode", "lm", "--arch", "qwen3-0.6b", "--requests", "5",
            "--max-new", "6", "--slots", "2"]

    def reference_weights(cfg, device):
        ref_cfg = smoke_config(get_config(cfg.name))
        tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                    ref_cfg))
        return lm_params_from_reference(tree, cfg, device)

    monkeypatch.setattr(port_serve, "_lm_params", reference_weights)
    got = _port_run(argv + ["--device", "cpu"])
    want = _ref_run(argv, monkeypatch)
    served = r"served (\d+) requests, (\d+) tokens in"
    assert re.findall(served, got) == re.findall(served, want) == [
        ("5", "30")]
    sample = [line for line in want.splitlines()
              if line.startswith("sample completion:")]
    assert len(sample) == 1 and sample[0] in got.splitlines()


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        _port_run(["--mode", "graph", "--n", "200"])
