"""The port stands alone: ``repro_torch`` imports neither JAX nor any module
of the reference package ``repro``, and neither does ``chip_smoke.py``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
import repro_torch
from repro_torch import KnnSpec, RangeSpec, build_index, make_dataset

pts = make_dataset("kitti", 400, seed=0)
res = build_index(pts, backend="trueknn", device="cpu").query(None, KnnSpec(4))
assert res.dists.shape == (400, 4) and np.isfinite(res.dists).all()
rng = build_index(pts, backend="brute", device="cpu").query(
    pts[:10], RangeSpec(1.0))
assert rng.n_queries == 10
import repro_torch.api.backends.fixed_radius
import repro_torch.workloads
from repro_torch.workloads import build_knn_graph, dbscan

fr = build_index(pts, backend="fixed_radius", radius=0.5, device="cpu")
assert build_knn_graph(fr, 3).n == 400
assert dbscan(fr, 0.5, 4).labels.shape == (400,)
import repro_torch.core.partition
import repro_torch.core.distributed_grid
from repro_torch import DeviceMesh
from repro_torch.core.distributed_grid import distributed_trueknn_grid

mesh = DeviceMesh([["cpu"] * 2] * 2, ("data", "model"))
dist = build_index(pts, backend="distributed", mesh=mesh, device="cpu")
assert dist.query(pts[:8], KnnSpec(3)).idxs.shape == (8, 3)
assert distributed_trueknn_grid(pts, 3, mesh)[1].shape == (400, 3)
sh = build_index(pts, backend="sharded", n_shards=4, device="cpu")
assert sh.query(pts[:8], KnnSpec(3)).timings["plan"].startswith("sharded")
import repro_torch.api.mutable
import repro_torch.api.backends.mutable
from repro_torch import make_mutable, map_to_stable
from repro_torch.core.distributed import PlacedFabric

placed = build_index(pts, backend="sharded", n_shards=4, device="cpu",
                     placement="devices", mesh=DeviceMesh(["cpu"] * 2))
assert "/placed=" in placed.query(pts[:8], KnnSpec(3)).timings["plan"]
assert placed.rebalance() is False  # 4 shards fill both positions
mut = make_mutable(placed, delta_rows=8, auto_compact="off")
mut.insert(pts[:20] + 0.01)
mut.delete([0, 401])
assert mut.query(pts[:8], KnnSpec(3)).timings["plan"] == "mutable/sources=2"
assert mut.compact() and mut.stats()["placement"]["mode"] == "devices"
import repro_torch.api.server
import repro_torch.core.knnlm
import repro_torch.launch.serve
import repro_torch.convert
from repro_torch import NeighborServer, Ticket, AdmissionError
from repro_torch.api import warm_default_radius, dropped_counts
from repro_torch.core import (Grid, brute_knn_engine, build_grid,
                              fixed_radius_round, max_knn_distance,
                              merge_knn, merge_range,
                              percentile_knn_distance, sample_start_radius,
                              topk_merge_rows)
from repro_torch.core.knnlm import build_datastore, knn_logprobs

srv = NeighborServer(indexes={"a": build_index(pts, backend="brute",
                                                device="cpu")})
assert srv.submit(pts[:4], KnnSpec(3), index="a").result().dists.shape == (4, 3)
assert max_knn_distance(pts, 3, device="cpu") > 0
store = build_datastore(np.random.default_rng(0).normal(
    size=(300, 8)).astype(np.float32), np.arange(300) % 7, device="cpu")
assert knn_logprobs(store, np.zeros((2, 8), np.float32), 7).shape == (2, 7)
import repro_torch.core as rcore
assert rcore.build_index is build_index
import torch
import repro_torch.models
import repro_torch.configs
import repro_torch.serve
import repro_torch.data
import repro_torch.examples
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.examples import quickstart, serve_knn
from repro_torch.models import forward, init_params
from repro_torch.serve import BatchedServer, ServeConfig

cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
assert forward(model, cfg, np.zeros((1, 4), np.int64))[0].shape == (1, 4, 64)
server = BatchedServer(cfg, model, ServeConfig(batch_slots=2))
server.submit([1, 2, 3])
assert len(server.run(max_new_tokens=2)[0]) == 2
assert len(ARCHS) == 10 and get_config("qwen3-0.6b").param_count() > 0
toks = SyntheticLMStream(DataConfig(64, 8, 2)).batch_at(0)["tokens"]
assert toks.shape == (2, 8)
repro_torch.launch.serve.main(["--mode", "lm", "--requests", "2",
                               "--max-new", "2", "--device", "cpu"])
import repro_torch.optim
import repro_torch.train
import repro_torch.launch.train
from repro_torch.examples import knnlm_serve, train_lm
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.train import TrainConfig, Trainer, make_train_step

tcfg = TrainConfig(warmup_steps=1, total_steps=2)
qcfg = smoke_config(get_config("qwen3-0.6b"))
qm = init_params(qcfg, torch.Generator().manual_seed(0), device="cpu")
tr = Trainer(qcfg, tcfg, qm, adamw_init(qm),
             SyntheticLMStream(DataConfig(qcfg.vocab_size, 8, 2)),
             make_train_step(qcfg, tcfg))
assert len(tr.run(2, log=lambda *_: None)) == 2
assert len(train_lm.main(["--preset", "smoke", "--steps", "2",
                          "--device", "cpu"])) == 2
import repro_torch.parallel
import repro_torch.launch.mesh
import repro_torch.launch.shapes
import repro_torch.launch.analysis
import repro_torch.launch.dryrun
from repro_torch.parallel import (compressed_psum_mean, param_shardings,
                                  pipeline_apply, shard_tree)
from repro_torch.launch import dryrun

rec = dryrun.lower_cell("smollm-135m", "decode_32k", False)
assert rec["status"] == "ok" and rec["cost_flops"] > 0
mesh = DeviceMesh(["cpu"] * 2, ("data",))
xs = {(i,): torch.full((3,), float(i + 1)) for i in range(2)}
assert torch.allclose(compressed_psum_mean(xs, mesh, "data")[(0,)],
                      torch.full((3,), 1.5), rtol=0.05)
import warnings
import repro_torch.core.trueknn
from repro_torch.core import TrueKNNResult, brute_knn, fixed_radius_knn, trueknn
from repro_torch.launch import make_host_mesh, make_production_mesh

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    assert isinstance(trueknn(pts, 3, device="cpu"), TrueKNNResult)
    assert brute_knn(pts, 3, queries=pts[:5], device="cpu")[0].shape == (5, 3)
    assert len(fixed_radius_knn(pts, 0.5, 3, device="cpu")) == 4
    assert build_index(pts, backend="brute", device="cpu").query(
        pts[:5], 3).idxs.shape == (5, 3)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
print("OK")
"""


def test_imports_and_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b(?!_torch))", re.M
)


def test_no_jax_or_reference_import_lines():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (str(f), hits)
