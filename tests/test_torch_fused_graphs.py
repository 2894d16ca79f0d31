"""The fused search replayed from CUDA graphs (``core.fused_loop.FusedGraphs``).

On the card a search whose key comes a second time is captured and later
ones replay it: answers, found, n_tests, rounds and the counters must be
the eager search's, bitwise, and the launch tallies must count what the
replays launched.  On the CPU nothing is captured.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import KnnSpec, build_index
from repro_torch.core.datasets import make_dataset
from repro_torch.kernels import build

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)


def _same(a, b):
    for key in ("dists", "idxs", "found"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    assert a.n_tests == b.n_tests
    assert ([(s.radius, s.n_queries, s.n_resolved, s.n_tests)
             for s in a.rounds]
            == [(s.radius, s.n_queries, s.n_resolved, s.n_tests)
                for s in b.rounds])
    for key in ("rounds_launched", "subgrid_rounds", "d2_evaluated"):
        assert a.timings[key] == b.timings[key], key


def test_launch_tallies_add_and_take_away():
    """``launches_since`` is what was counted after a snapshot;
    ``add_launches`` adds it again, or with sign -1 takes it away."""
    before = build.launch_snapshot()
    build.count_launch("grid_round", wide=True)
    build.count_launch("pairwise_topk")
    delta = build.launches_since(before)
    assert delta == ({"pairwise_topk": 1, "grid_round": 1},
                     {"pairwise_topk": 0, "grid_round": 1})
    build.add_launches(delta, -1)
    assert build.launch_snapshot() == before
    build.add_launches(delta)
    build.add_launches(delta, -1)
    assert build.launch_snapshot() == before


@pytest.mark.parametrize("self_rows", [False, True])
def test_cpu_searches_are_never_captured(self_rows):
    """On the CPU every search runs eagerly: repeated batches equal a
    fresh index's, and the index reports no capture and no replay."""
    pts = make_dataset("kitti", 3000, seed=3)
    rng = np.random.default_rng(4)
    q = None if self_rows else (
        pts[rng.choice(3000, 64, replace=False)]
        + rng.normal(scale=0.05, size=(64, 3))).astype(np.float32)
    index = build_index(pts, backend="trueknn", device="cpu")
    got = [index.query(q, KnnSpec(8)) for _ in range(3)]
    stats = index.stats()
    assert stats["fused_graph_captures"] == 0
    assert stats["fused_graph_replays"] == 0
    fresh = build_index(pts, backend="trueknn", device="cpu")
    want = [fresh.query(q, KnnSpec(8)) for _ in range(3)]
    for a, b in zip(got, want):
        _same(a, b)


def _bench_cloud(config):
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import json

    from knnbench.datagen import make_cloud

    cfg = json.loads((root / "knnbench" / "configs"
                      / f"{config}.json").read_text())
    return make_cloud(cfg), int(cfg["k"])


@needs_card
@pytest.mark.parametrize("config,self_rows", [
    ("kitti_map_1m", False), ("kitti_map_1m_draw1", False),
    ("porto_gps_1m", True), ("kitti_map_1m_sor", True)])
def test_cuda_replays_equal_eager_searches(config, self_rows):
    """A cell's batches (scans from a pool of two, or the whole cloud's
    self query) through one index, whose searches are captured and
    replayed, and through one whose searches all run eagerly: every
    answer, count and round bitwise equal, and equal launch tallies."""
    cloud, k = _bench_cloud(config)
    rng = np.random.default_rng(7)
    pool = [None]
    if not self_rows:
        pool = [(cloud[rng.choice(len(cloud), 1 << 17, replace=False)]
                 + rng.normal(scale=0.05, size=(1 << 17, 3))
                 ).astype(np.float32) for _ in range(2)]

    def batches(graphs: bool):
        index = build_index(cloud, backend="trueknn", device="cuda")
        if not graphs:
            index._graphs = None
        before = build.launch_snapshot()
        out = [index.query(pool[b % len(pool)], KnnSpec(k))
               for b in range(3 * len(pool) + 1)]
        return index, out, build.launches_since(before)

    index, got, got_launches = batches(True)
    _, want, want_launches = batches(False)
    for a, b in zip(got, want):
        _same(a, b)
    assert got_launches == want_launches
    stats = index.stats()
    assert stats["fused_graph_failures"] == 0
    assert stats["fused_graph_captures"] >= 1
    assert stats["fused_graph_replays"] >= len(pool)
