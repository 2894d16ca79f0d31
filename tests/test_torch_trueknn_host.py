"""The port's TrueKNN backend against the JAX package on the host round
loop (``fused=False``): the cases of ``test_torch_trueknn.py``, and the
port's own fused loop held equal to its host loop.
"""

import numpy as np
import pytest

from repro_torch import KnnSpec, build_index
from torch_trueknn_cases import (
    CLOUDS, PTS, QS, check_cloud, check_explicit_start_radius_and_self_hybrid,
    check_max_rounds_bailout, check_stop_radius_tails, rounds_of,
)


@pytest.mark.parametrize("cloud", CLOUDS)
def test_trueknn_matches_reference(cloud):
    check_cloud(cloud, fused=False)


def test_stop_radius_tails():
    check_stop_radius_tails(fused=False)


def test_max_rounds_bailout_runs_the_brute_tail():
    check_max_rounds_bailout(fused=False)


def test_explicit_start_radius_and_self_hybrid():
    check_explicit_start_radius_and_self_hybrid(fused=False)


def test_fused_equals_host_loop_in_the_port():
    fused, host = (build_index(PTS, backend="trueknn", device="cpu",
                               fused=f) for f in (True, False))
    for q in (None, QS):
        a, b = fused.query(q, KnnSpec(6)), host.query(q, KnnSpec(6))
        assert np.array_equal(a.dists, b.dists)
        assert np.array_equal(a.idxs, b.idxs)
        assert np.array_equal(a.found, b.found)
        assert rounds_of(a) == rounds_of(b)
