"""The port's TrueKNN backend against the JAX package on the fused loop
(the default), answers and telemetry.

The cases (``torch_trueknn_cases.py``) cover all five ``make_dataset``
clouds, self and external queries, KnnSpec and HybridSpec, and the corner
cases of ``tests/test_fused_loop.py`` (stop_radius, the max_rounds
bail-out, an explicit start radius).  ``test_torch_trueknn_host.py`` runs
the same cases on the host round loop.
"""

import numpy as np
import pytest

import repro.api as jax_api
from repro_torch import KnnSpec, build_index, make_dataset
from repro_torch.convert import trueknn_state_from_numpy
from torch_trueknn_cases import (
    CLOUDS, N, check_cloud, check_explicit_start_radius_and_self_hybrid,
    check_max_rounds_bailout, check_stop_radius_tails, rounds_of,
)


@pytest.mark.parametrize("cloud", CLOUDS)
def test_trueknn_matches_reference(cloud):
    check_cloud(cloud, fused=True)


def test_stop_radius_tails():
    check_stop_radius_tails(fused=True)


def test_max_rounds_bailout_runs_the_brute_tail():
    check_max_rounds_bailout(fused=True)


def test_explicit_start_radius_and_self_hybrid():
    check_explicit_start_radius_and_self_hybrid(fused=True)


def test_seeded_warm_state_matches_reference():
    """The same lattice and warm state fed to both packages (through
    ``convert.trueknn_state_from_numpy``) gives the same warm batch."""
    pts = make_dataset("kitti", N, seed=2)
    qs = make_dataset("kitti", 50, seed=3)
    ref = jax_api.build_index(pts, backend="trueknn")
    ref.query(None, jax_api.KnnSpec(8))
    port = build_index(pts, backend="trueknn", device="cpu")
    trueknn_state_from_numpy(
        ref._anchor, ref._j_cap, ref._warm_r, ref._sampled_r
    ).apply(port)
    got = port.query(qs, KnnSpec(8))
    want = ref.query(qs, jax_api.KnnSpec(8))
    assert got.timings["start_radius_source"] == "warm"
    assert np.array_equal(got.dists, want.dists)
    assert np.array_equal(got.idxs, want.idxs)
    assert [r[1] for r in rounds_of(got)] == [r[1] for r in rounds_of(want)]
