"""The port's distributed engines and backend against the JAX package's.

The reference needs a mesh of 8 devices, and JAX fixes its device count
when it starts, so one module-scoped subprocess runs every reference case
with ``--xla_force_host_platform_device_count=8`` on a (2, 4) data x model
mesh and saves what it returns to an ``.npz``.  The port runs here, on an
8-position CPU ``DeviceMesh`` of the same shape (one device at every
position).  Inputs come from numpy seeds.

On the CPU the port's per-shard engines reproduce the reference's float
forms (the dense engine's FMA chain, the grid round's), and its merge
keeps ``lax.top_k``'s tie order, so answers, counts, rounds and the
candidate-test counts are ``np.array_equal`` — ties across shards
included, which the duplicate cloud pins.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import (
    AllPairsSpec,
    DeviceMesh,
    HybridSpec,
    KnnSpec,
    RangeSpec,
    build_index,
    make_dataset,
)
from repro_torch.core.distributed import (
    distributed_trueknn,
    make_distributed_knn,
    place_shards,
)
from repro_torch.core.distributed_grid import distributed_trueknn_grid
from repro_torch.kernels.ops import topk_engine
from repro_torch.kernels.ref import pairwise_topk_ref

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)


def _knn_inputs():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(512, 3)).astype(np.float32)
    qs = rng.normal(size=(64, 3)).astype(np.float32)
    return pts, qs


def _dup_inputs():
    """Exact copies of a few points in every one of the 4 shards (128 rows
    each), queried at those points with and without self ids: equal
    distances across shards, which the merge must give to the lowest
    index."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(size=(512, 3)).astype(np.float32)
    for j in range(1, 4):
        pts[128 * j + 5] = pts[5]
        pts[128 * j + 40] = pts[40]
        pts[128 * j + 99] = pts[200]
    qs = np.concatenate([pts[[5, 40, 200, 133, 296, 424]],
                         rng.uniform(size=(10, 3)).astype(np.float32)])
    qid = np.full((16,), -1, np.int32)
    qid[[0, 3, 4]] = [5, 133, 296]  # self ids in shards 0, 1 and 2
    qid[5] = 424  # in shard 3
    return pts, qs, qid


_INDEX_PTS = ("porto", 512, 5)
_INDEX_QS = ("porto", 24, 6)

_REFERENCE = r"""
import sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {test_dir!r})
from test_torch_distributed import _knn_inputs, _dup_inputs, _INDEX_PTS, \
    _INDEX_QS
import repro.api as api
from repro.core.datasets import make_dataset
from repro.core.distributed import make_distributed_knn, distributed_trueknn
from repro.core.distributed_grid import distributed_trueknn_grid

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {{}}

def knn(tag, pts, qs, qid, k, radius):
    fn = jax.jit(make_distributed_knn(mesh, k, radius=radius,
                                      use_kernel=False))
    res = fn(jax.device_put(pts, NamedSharding(mesh, P("model", None))),
             jax.device_put(qs, NamedSharding(mesh, P("data", None))),
             jax.device_put(qid, NamedSharding(mesh, P("data"))))
    for name, a in zip("dic", res):
        out[f"{{tag}}_{{name}}"] = np.asarray(a)

pts, qs = _knn_inputs()
none = np.full((64,), -1, np.int32)
knn("knn_inf", pts, qs, none, 5, np.inf)
knn("knn_fin", pts, qs, none, 5, 0.7)
dpts, dqs, dqid = _dup_inputs()
knn("dup", dpts, dqs, dqid, 6, 0.3)

p = make_dataset("porto", 1024, seed=3)
d, i, rounds, n_tests = distributed_trueknn(p, 4, mesh)
out.update(tk_d=d, tk_i=i, tk_rounds=rounds, tk_tests=n_tests)

p = make_dataset("porto", 1030, seed=3)
d, i, st = distributed_trueknn_grid(p, 4, mesh)
out.update(grid_d=d, grid_i=i, grid_tests=st["total_tests"],
           grid_r0=st["start_radius"],
           grid_rounds=np.array([[r[key] for key in (
               "radius", "queries", "resolved", "tests", "cap", "table")]
               for r in st["rounds"]]))

pts = make_dataset(*_INDEX_PTS[:2], seed=_INDEX_PTS[2])
qs = make_dataset(*_INDEX_QS[:2], seed=_INDEX_QS[2])
index = api.build_index(pts, backend="distributed", mesh=mesh)
r = float(np.percentile(
    np.sort(np.sqrt(((qs[:, None] - pts[None]) ** 2).sum(-1)), 1)[:, 3],
    60))
specs = {{
    "knn_qs": (qs, api.KnnSpec(4), "l2"),
    "knn_self": (None, api.KnnSpec(4), "l2"),
    "stop": (qs, api.KnnSpec(4, stop_radius=r), "l2"),
    "hybrid": (qs, api.HybridSpec(4, r), "l2"),
    "range": (qs, api.RangeSpec(r), "l2"),
    "cosine": (qs, api.KnnSpec(4), "cosine"),
}}
for tag, (q, spec, metric) in specs.items():
    res = index.query(q, spec, metric=metric)
    out[f"ix_{{tag}}_plan"] = np.array(res.timings.get("plan", "native"))
    out[f"ix_{{tag}}_tests"] = res.n_tests
    if hasattr(res, "offsets"):
        for key in ("offsets", "idxs", "dists"):
            out[f"ix_{{tag}}_{{key}}"] = getattr(res, key)
    else:
        for key in ("dists", "idxs"):
            out[f"ix_{{tag}}_{{key}}"] = getattr(res, key)
        if res.found is not None:
            out[f"ix_{{tag}}_found"] = res.found
stats = index.stats()
out.update(ix_radius=r, ix_batches=stats["batches"],
           ix_served=stats["queries_served"],
           ix_total_tests=stats["total_tests"],
           ix_mesh=np.array(sorted(stats["mesh_shape"].items())))
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("distributed") / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    script = _REFERENCE.format(test_dir=str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _mesh(device="cpu"):
    return DeviceMesh([[device] * 4] * 2, ("data", "model"))


def _same_knn(got, ref, tag):
    for name, a in zip("dic", got):
        assert np.array_equal(a.cpu().numpy(), ref[f"{tag}_{name}"]), name


@pytest.mark.parametrize("radius", [np.inf, 0.7], ids=["inf", "fin"])
def test_make_distributed_knn(ref, radius):
    pts, qs = _knn_inputs()
    fn = make_distributed_knn(_mesh(), 5, radius=radius)
    got = fn(pts, qs, np.full((64,), -1, np.int32))
    _same_knn(got, ref, "knn_inf" if np.isinf(radius) else "knn_fin")
    # placed once, answered the same
    again = fn(place_shards(pts, _mesh()), qs, np.full((64,), -1, np.int32))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_ties_across_shards_pin_the_returned_copy(ref):
    """Duplicates in every shard: each data slice returns model position
    0's copy, whose [own, partner] merges keep the lowest index first —
    the copy and order ``shard_map`` returns.  Self ids land in every
    shard (negative or >= N/P on the others)."""
    pts, qs, qid = _dup_inputs()
    got = make_distributed_knn(_mesh(), 6, radius=0.3)(pts, qs, qid)
    _same_knn(got, ref, "dup")
    idx = got[1].numpy()
    assert list(idx[1, :4]) == [40, 168, 296, 424]  # four copies of 40
    assert 5 not in idx[0] and 133 not in idx[3]  # self excluded


def test_distributed_trueknn(ref):
    pts = make_dataset("porto", 1024, seed=3)
    d, i, rounds, n_tests = distributed_trueknn(pts, 4, _mesh())
    assert np.array_equal(d, ref["tk_d"])
    assert np.array_equal(i, ref["tk_i"])
    assert rounds == int(ref["tk_rounds"])
    assert n_tests == int(ref["tk_tests"])
    assert isinstance(n_tests, int)


def test_distributed_trueknn_grid(ref):
    """N = 1030 does not divide into 8 shards: padded shards, an
    out-of-shard self id mapped to no self, the per-round stats."""
    pts = make_dataset("porto", 1030, seed=3)
    d, i, st = distributed_trueknn_grid(pts, 4, _mesh())
    assert np.array_equal(d, ref["grid_d"])
    assert np.array_equal(i, ref["grid_i"])
    assert st["start_radius"] == float(ref["grid_r0"])
    assert st["total_tests"] == int(ref["grid_tests"])
    rounds = np.array([[r[key] for key in (
        "radius", "queries", "resolved", "tests", "cap", "table")]
        for r in st["rounds"]])
    assert np.array_equal(rounds, ref["grid_rounds"])
    assert st["grid_build_seconds"] >= 0.0


@pytest.fixture(scope="module")
def index_pair(ref):
    pts = make_dataset(*_INDEX_PTS[:2], seed=_INDEX_PTS[2])
    qs = make_dataset(*_INDEX_QS[:2], seed=_INDEX_QS[2])
    index = build_index(pts, backend="distributed", mesh=_mesh(),
                        device="cpu")
    r = float(ref["ix_radius"])
    specs = {
        "knn_qs": (qs, KnnSpec(4), "l2"),
        "knn_self": (None, KnnSpec(4), "l2"),
        "stop": (qs, KnnSpec(4, stop_radius=r), "l2"),
        "hybrid": (qs, HybridSpec(4, r), "l2"),
        "range": (qs, RangeSpec(r), "l2"),
        "cosine": (qs, KnnSpec(4), "cosine"),
    }
    got = {tag: index.query(q, spec, metric=metric)
           for tag, (q, spec, metric) in specs.items()}
    return index, got


_PLANS = {"knn_qs": "native", "knn_self": "native", "stop": "knn_fallback",
          "hybrid": "knn_filter", "range": "knn_sweep", "cosine": "l2_view"}


@pytest.mark.parametrize("tag", list(_PLANS))
def test_distributed_index(ref, index_pair, tag):
    """``build_index(backend="distributed")`` on the mesh: native kNN,
    ``stop_radius`` through the companion trueknn, hybrid and range
    through the generic routes, cosine through the L2 view."""
    res = index_pair[1][tag]
    assert res.timings.get("plan", "native") == str(ref[f"ix_{tag}_plan"]) \
        == _PLANS[tag]
    assert res.n_tests == int(ref[f"ix_{tag}_tests"])
    keys = ("offsets", "idxs", "dists") if hasattr(res, "offsets") else \
        ("dists", "idxs", "found")
    for key in keys:
        if key == "found" and f"ix_{tag}_found" not in ref:
            assert res.found is None
            continue
        assert np.array_equal(getattr(res, key), ref[f"ix_{tag}_{key}"]), key


def test_distributed_index_stats(ref, index_pair):
    s = index_pair[0].stats()
    assert s["batches"] == int(ref["ix_batches"])
    assert s["queries_served"] == int(ref["ix_served"])
    assert s["total_tests"] == int(ref["ix_total_tests"])
    assert sorted((k, str(v)) for k, v in s["mesh_shape"].items()) == \
        [tuple(row) for row in ref["ix_mesh"].tolist()]
    assert "use_kernel" not in s and s["device"] == "cpu"


def test_default_mesh_and_device_checks():
    pts = make_dataset("porto", 64, seed=0)
    index = build_index(pts, backend="distributed", device="cpu",
                        use_kernel=True)
    assert index.stats()["mesh_shape"] == {"model": 1}
    assert "use_kernel" not in index.stats()  # accepted, chooses nothing
    with pytest.raises(ValueError, match="equal shards"):
        build_index(pts[:63], backend="distributed", device="cpu",
                    mesh=DeviceMesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="pow2"):
        make_distributed_knn(DeviceMesh(["cpu"] * 3), 2)
    with pytest.raises(ValueError, match="axis"):
        DeviceMesh([["cpu"] * 2] * 2, ("model",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(pts, backend="distributed")


def test_stacked_grids_that_cannot_fit_raise(monkeypatch):
    """A shared (table, cap) whose buckets exceed the device's free bytes
    raises before allocating, naming every shard's own shape."""
    from repro_torch.core import distributed_grid as dg

    shards, n_valid = dg.shard_points(make_dataset("porto", 1030, seed=2), 8)
    _, table, cap = dg.build_stacked_grids(shards, n_valid, 0.05,
                                           device="cpu")
    need = 2 * 8 * table * cap * 4
    monkeypatch.setattr(dg, "_device_bytes", lambda dev: need - 1)
    with pytest.raises(MemoryError, match=r"shards ask for .*ROADMAP"):
        dg.build_stacked_grids(shards, n_valid, 0.05, device="cpu")
    monkeypatch.setattr(dg, "_device_bytes", lambda dev: need)
    dg.build_stacked_grids(shards, n_valid, 0.05, device="cpu")


# -- on the card ------------------------------------------------------------


@needs_card
def test_cuda_mesh_equals_cpu_mesh():
    """Dense and grid engines on a 4-position mesh on the card equal the
    same mesh on the CPU."""
    pts = make_dataset("kitti", 4096, seed=2)
    qs = make_dataset("kitti", 256, seed=3)
    cpu = DeviceMesh(["cpu"] * 4)
    gpu = DeviceMesh(["cuda"] * 4)
    for q in (qs, None):
        want = distributed_trueknn(pts, 8, cpu, queries=q)
        got = distributed_trueknn(pts, 8, gpu, queries=q)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        want = distributed_trueknn_grid(pts, 8, cpu, queries=q)
        got = distributed_trueknn_grid(pts, 8, gpu, queries=q)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[2]["rounds"] == want[2]["rounds"]


@needs_card
@pytest.mark.parametrize("k", [5, 40])
def test_cuda_pairwise_topk_out_of_range_self_ids(k):
    """The kernel skips a self id only inside its point range: negative
    ids and ids >= N (a query of another shard) exclude nothing."""
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.uniform(size=(5000, 3)).astype(np.float32))
    q = torch.as_tensor(rng.uniform(size=(300, 3)).astype(np.float32))
    qid = torch.as_tensor(rng.integers(-6000, 11000, 300).astype(np.int32))
    want = pairwise_topk_ref(q, p, k, radius2=0.01, query_ids=qid)
    dev = torch.device("cuda")
    got = topk_engine(q.to(dev), qid.to(dev), p.to(dev), 0.01, k=k)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@needs_card
def test_cuda_sharded_trueknn_children_equal_cpu():
    """The sharded composite (``placement="host"``, 8 trueknn children) on
    the card (the children's ``grid_round`` and ``pairwise_topk`` kernels)
    and on the CPU (their plain versions)."""
    pts = make_dataset("kitti", 4096, seed=2)
    qs = make_dataset("kitti", 256, seed=3)
    cpu = build_index(pts, backend="sharded", device="cpu")
    gpu = build_index(pts, backend="sharded", device="cuda")
    assert {c.device.type for c in gpu._children} == {"cuda"}
    brute = build_index(pts, backend="brute", device="cpu")
    r = float(np.median(brute.query(qs, KnnSpec(8)).dists[:, 7]))
    for q, spec in ((qs, KnnSpec(8)), (None, KnnSpec(8)),
                    (qs, HybridSpec(8, r)), (qs, RangeSpec(r)),
                    (None, AllPairsSpec(8))):
        want = cpu.query(q, spec)
        got = gpu.query(q, spec)
        assert got.n_tests == want.n_tests
        assert got.timings["plan"] == want.timings["plan"]
        for key in ("offsets", "idxs", "dists", "found"):
            if hasattr(want, key) and getattr(want, key) is not None:
                assert np.array_equal(getattr(got, key),
                                      getattr(want, key)), key
