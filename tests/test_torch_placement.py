"""The port's placed sharded index (``placement="devices"``) against the
JAX package's.

JAX fixes its device count when it starts, so the reference runs in one
subprocess per device count P in {1, 2, 4, 8}
(``--xla_force_host_platform_device_count=P``, all four started together)
and saves what ``torch_placement_cases.run_all`` returns; the port runs
the same cases here on a P-position CPU ``DeviceMesh`` (the one CPU at
every position).  Slot padding (5 shards on 2, 4 and 8 positions),
rebalance splits into free slots and the per-position occupancy all
depend on P.

On the CPU every slot dispatch runs the ``pairwise_topk`` kernel's plain
version in the reference's float forms (the diff-form squared L2 at every
d, ``l2diff``; the sequential L1), so answers, CSRs, truncation flags,
each round's radius, plan tags, dispatch counts and the ``stats()``
counters are ``np.array_equal``.  One exception: at d = 64 XLA does not
sum ``diff * diff`` in axis order, so that group holds distances to the
reference tests' 1e-4 and compares each row's indices as a set.
"""

import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import DeviceMesh, KnnSpec, build_index, make_dataset
from repro_torch.api import get_metric
from torch_placement_cases import GROUPS, inputs, run_all

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
DEVICE_COUNTS = (1, 2, 4, 8)
TOL = 1e-4  # the reference's float32-engine tolerance

_REFERENCE = r"""
import pickle, sys
sys.path.insert(0, {test_dir!r})
import jax
import repro.api as api
from repro.core import make_dataset
from torch_placement_cases import run_all

assert len(jax.devices()) == {p}, jax.devices()
with open(sys.argv[1], "wb") as f:
    pickle.dump(run_all(api, make_dataset), f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """P -> the reference's outputs; the four subprocesses run at once."""
    tmp = tmp_path_factory.mktemp("placement")
    procs = {}
    for p in DEVICE_COUNTS:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={p}")
        script = _REFERENCE.format(test_dir=str(Path(__file__).parent), p=p)
        procs[p] = subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / f"ref{p}.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for p, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"ref{p}.pkl", "rb") as f:
            out[p] = pickle.load(f)
    return out


_PORT = types.SimpleNamespace(
    build_index=repro_torch.build_index, KnnSpec=repro_torch.KnnSpec,
    HybridSpec=repro_torch.HybridSpec, RangeSpec=repro_torch.RangeSpec,
    get_metric=get_metric)


@pytest.fixture(scope="module")
def port():
    cache = {}

    def get(p):
        if p not in cache:
            cache[p] = run_all(_PORT, make_dataset, device="cpu",
                               mesh=DeviceMesh(["cpu"] * p))
        return cache[p]

    return get


def _same(key, a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, key
        assert np.array_equal(a, b), key
    else:
        assert a == b, (key, a, b)


def _same_up_to_tol(key, a, b):
    """d = 64: distances to TOL, each row's indices as a set (a CSR's
    values row by row in ``_csr_rows_equal``), the same number of rounds
    (a kth distance a rounding apart may resolve a row in another one)."""
    name = key.rsplit("/", 1)[1]
    if name == "dists" and a.ndim == 2:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6)
    elif name == "idxs" and a.ndim == 2:
        assert np.array_equal(np.sort(a, 1), np.sort(b, 1)), key
    elif name == "rounds":
        assert len(a) == len(b), key
    elif name not in ("dists", "idxs"):
        _same(key, a, b)


def _csr_rows_equal(ref, got, tag):
    offs = ref[f"{tag}/offsets"]
    for i in range(len(offs) - 1):
        sl = slice(offs[i], offs[i + 1])
        assert np.array_equal(np.sort(ref[f"{tag}/idxs"][sl]),
                              np.sort(got[f"{tag}/idxs"][sl])), (tag, i)
        np.testing.assert_allclose(np.sort(ref[f"{tag}/dists"][sl]),
                                   np.sort(got[f"{tag}/dists"][sl]),
                                   rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("p", DEVICE_COUNTS)
def test_placed_equals_reference(ref, port, p, group):
    want, got = ref[p], port(p)
    keys = [k for k in want if k.split("/")[0] == group]
    assert keys, group
    for key in keys:
        if group == "d64":
            _same_up_to_tol(key, want[key], got[key])
        else:
            _same(key, want[key], got[key])
    if group == "d64":
        _csr_rows_equal(want, got, "d64/range")


def test_what_the_cases_exercise(port):
    """The cases reach what they are meant to: escalated ranges take two
    dispatches, rebalance splits exactly where a free slot exists, plan
    tags carry ``/placed=``, the capped range is ragged and truncated."""
    for p in DEVICE_COUNTS:
        out = port(p)
        for metric in ("l2", "l1"):
            assert out[f"escalate/{metric}/fused_dispatches"] == 2
        slots = out["stats/porto/placement"]["slots"]
        assert slots % p == 0 and slots >= 5
        assert out["rebalance/moved"] is (slots > 5)
        occ = out["stats/porto/placement"]["device_occupancy"]
        assert len(occ) == p and sum(occ) == 700
        assert out["matrix-l2/knn/plan"].startswith("sharded/pruned=")
        assert "/placed=" in out["matrix-l2/knn/plan"]
        assert out["matrix-l2/hybrid/fused_dispatches"] == 1
        trunc = out["matrix-l2/range_capped/truncated"]
        assert trunc.any() and not trunc.all()
        assert out["auto/n_shards"] % p == 0
        assert out["stats/porto/child_dispatches"] == 0


def test_placed_equals_host_placement():
    """Placed answers equal the host fabric's bitwise, every metric."""
    pts, qs = inputs(make_dataset)
    mesh = DeviceMesh(["cpu"] * 4)
    placed = build_index(pts, backend="sharded", n_shards=5, device="cpu",
                         placement="devices", mesh=mesh)
    host = build_index(pts, backend="sharded", n_shards=5, device="cpu")
    for metric in ("l2", "l1", "linf", "cosine"):
        a = placed.query(qs, KnnSpec(4), metric=metric)
        b = host.query(qs, KnnSpec(4), metric=metric)
        assert np.array_equal(a.dists, b.dists)
        assert np.array_equal(a.idxs, b.idxs)
        assert np.array_equal(a.found, b.found)
    assert host.rebalance() is False
    assert host.stats()["placement"] == {"mode": "host"}


def test_mesh_checks():
    pts, _ = inputs(make_dataset)
    with pytest.raises(ValueError, match="1-D"):
        build_index(pts, backend="sharded", device="cpu",
                    placement="devices",
                    mesh=DeviceMesh([["cpu"] * 2] * 2, ("data", "model")))
    index = build_index(pts, backend="sharded", device="cpu",
                        placement="devices")
    assert index.stats()["placement"]["devices"] == 1  # one CPU position


# -- on the card: the same cases through the CUDA kernels ---------------------

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)


@needs_card
def test_cuda_placed_equals_cpu(port):
    """Every case on a 4-position mesh of the card (the slot launches are
    the ``pairwise_topk`` kernel, ``l2diff`` included) equals the same case
    on the CPU's plain versions bitwise, d = 64 too."""
    from repro_torch.kernels import build

    build.reset_launches()
    got = run_all(_PORT, make_dataset, device="cuda",
                  mesh=DeviceMesh(["cuda"] * 4))
    assert build.launch_counts()["pairwise_topk"] > 0
    want = port(4)
    assert got.keys() == want.keys()
    for key in want:
        _same(key, want[key], got[key])


@needs_card
def test_cuda_mutable_over_placed_equals_cpu():
    """Inserts, deletes and a compaction over a placed base on the card
    answer as on the CPU, bitwise."""
    from repro_torch import HybridSpec, RangeSpec, make_mutable

    pts, qs = inputs(make_dataset)
    extra = make_dataset("porto", 96, seed=21)
    out = []
    for dev in ("cpu", "cuda"):
        base = build_index(pts, backend="sharded", n_shards=4, device=dev,
                           placement="devices", mesh=DeviceMesh([dev] * 2))
        mut = make_mutable(base, delta_rows=32, auto_compact="off")
        mut.insert(extra)
        mut.delete([3, 700, 701])
        res = [mut.query(qs, s) for s in (KnnSpec(4), HybridSpec(4, 0.05),
                                          RangeSpec(0.05))]
        mut.compact()
        res.append(mut.query(qs, KnnSpec(4)))
        out.append(res)
    for a, b in zip(*out):
        for key in ("dists", "idxs", "offsets"):
            if hasattr(a, key):
                assert np.array_equal(getattr(a, key), getattr(b, key)), key
