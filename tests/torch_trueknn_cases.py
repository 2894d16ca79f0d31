"""Shared cases of the port's TrueKNN parity tests.

``test_torch_trueknn.py`` runs them on the fused loop and
``test_torch_trueknn_host.py`` on the host round loop; they are two files
so that a run with one worker per file spreads the reference's compiles.

On the CPU the port runs the plain versions of its kernels, which
reproduce the reference's float forms, so every answer (dists, idxs,
found) and every counter (rounds, tests, grid builds and hits, the start
radius and its source, the warm-start EMA) must be ``np.array_equal``.
"""

import numpy as np
import torch

import repro.api as jax_api
from repro_torch import HybridSpec, KnnSpec, build_index, make_dataset

torch.set_num_threads(1)

CLOUDS = ["uniform", "porto", "road", "iono", "kitti"]
N = 400

_TIMING_KEYS = (
    "grid_builds", "grid_cache_hits", "start_radius_source",
    "warm_start_radius", "resolved_radius_p50", "plan", "fused_dispatches",
)
_STAT_KEYS = (
    "batches", "queries_served", "grid_builds", "grid_cache_hits", "rounds",
    "brute_tail_queries", "dispatches", "query_upload_skips",
    "cached_grids", "warm_radius", "fused", "grid_probe_hits",
    "grid_probe_misses",
)

PTS = make_dataset("porto", 500, seed=4)
QS = np.concatenate(
    [make_dataset("porto", 20, seed=11), np.float32([[40.0, 40.0],
                                                     [-35.0, 20.0]])]
)


def rounds_of(res):
    return [
        (r.round_idx, r.radius, r.n_queries, r.n_resolved, r.n_tests,
         tuple(r.grid_res), r.grid_cap, r.cache_hit)
        for r in res.rounds
    ]


def assert_same(got, want):
    """Answer and telemetry identity (wall-clock fields excepted)."""
    assert np.array_equal(got.dists, want.dists)
    assert np.array_equal(got.idxs, want.idxs)
    assert got.dists.dtype == want.dists.dtype == np.float32
    if want.found is None:
        assert got.found is None
    else:
        assert np.array_equal(got.found, want.found)
    assert got.n_tests == want.n_tests
    assert rounds_of(got) == rounds_of(want)
    assert got.start_radius == want.start_radius
    assert got.final_radius == want.final_radius
    for key in _TIMING_KEYS:
        assert got.timings.get(key) == want.timings.get(key), key


def pair(pts, **cfg):
    return (
        build_index(pts, backend="trueknn", device="cpu", **cfg),
        jax_api.build_index(pts, backend="trueknn", **cfg),
    )


def assert_same_stats(port, ref):
    got, want = port.stats(), ref.stats()
    for key in _STAT_KEYS:
        assert got[key] == want[key], key


def check_cloud(cloud, fused):
    """Batch 1 samples its start radius (Alg. 2) on a self-query, batch 2
    starts warm on external queries, batch 3 is a radius-capped hybrid."""
    pts = make_dataset(cloud, N, seed=1)
    qs = make_dataset(cloud, 40, seed=9)
    ext = float((pts.max(0) - pts.min(0)).max())
    port, ref = pair(pts, fused=fused)
    for q, spec in ((None, KnnSpec(8)), (qs, KnnSpec(8)),
                    (qs, HybridSpec(5, ext / 50))):
        jspec = (jax_api.KnnSpec(spec.k) if isinstance(spec, KnnSpec)
                 else jax_api.HybridSpec(spec.k, spec.radius))
        assert_same(port.query(q, spec), ref.query(q, jspec))
    assert_same_stats(port, ref)
    if fused:
        assert port.stats()["dispatches"] == 3  # one per fused search


def check_stop_radius_tails(fused):
    port, ref = pair(PTS, fused=fused)
    got = port.query(QS, KnnSpec(5, stop_radius=0.02))
    want = ref.query(QS, jax_api.KnnSpec(5, stop_radius=0.02))
    assert_same(got, want)
    assert (got.found < 5).any() and np.isinf(got.dists).any()


def check_max_rounds_bailout(fused):
    port, ref = pair(PTS, fused=fused, growth=1.01, max_rounds=3)
    got = port.query(QS, KnnSpec(5))
    assert_same(got, ref.query(QS, jax_api.KnnSpec(5)))
    assert np.isinf(got.rounds[-1].radius)  # the tail ran
    assert_same_stats(port, ref)


def check_explicit_start_radius_and_self_hybrid(fused):
    port, ref = pair(PTS, fused=fused)
    assert_same(port.query(QS, KnnSpec(3, start_radius=2.0)),
                ref.query(QS, jax_api.KnnSpec(3, start_radius=2.0)))
    assert_same(port.query(None, HybridSpec(4, 0.01)),
                ref.query(None, jax_api.HybridSpec(4, 0.01)))
