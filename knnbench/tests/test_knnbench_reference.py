"""The plain reference against a NumPy argsort, and its control against
the comparison, at sizes a CPU test holds."""

import numpy as np
import pytest
import torch

from knnbench import compare, reference


def _numpy_knn(points, queries, k, exclude=None):
    """Exact kNN by a full float64 argsort (stable: ties by index)."""
    p = points.astype(np.float64)
    q = queries.astype(np.float64)
    d = np.sqrt(((q[:, None, :] - p[None, :, :]) ** 2).sum(-1))
    if exclude is not None:
        d[np.arange(len(q)), exclude] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), order


def _cloud(seed, n, dim, dup=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, dim)).astype(np.float32) * 10
    if dup:
        # exact duplicates and points at equal distances make ties
        pts[-dup:] = pts[:dup]
        pts[1] = pts[0] + np.float32(0.5)
        pts[2] = pts[0] - np.float32(0.5)
    return pts


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dup", [0, 16])
def test_exact_knn_equals_numpy_argsort(dim, dup):
    pts = _cloud(dim * 100 + dup, 600, dim, dup)
    q = np.concatenate([pts[:40], _cloud(7, 40, dim)])
    want_d, want_i = _numpy_knn(pts, q, 8)
    got_d, got_i = reference.exact_knn(torch.from_numpy(pts),
                                       torch.from_numpy(q), 8, block=17)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12, atol=0)
    assert np.array_equal(got_i.numpy(), want_i)


def test_exact_knn_excludes_self_with_ties():
    pts = _cloud(5, 500, 3, dup=32)
    ids = np.arange(0, 500, 7)
    want_d, want_i = _numpy_knn(pts, pts[ids], 8, exclude=ids)
    got_d, got_i = reference.exact_knn(
        torch.from_numpy(pts), torch.from_numpy(pts[ids]), 8,
        exclude=torch.from_numpy(ids), block=9)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12, atol=0)
    assert np.array_equal(got_i.numpy(), want_i)
    assert not (got_i.numpy() == ids[:, None]).any()


def _judge(pts, q, got_d, got_i, exclude=None):
    t_pts, t_q = torch.from_numpy(pts), torch.from_numpy(q)
    ex = None if exclude is None else torch.from_numpy(exclude)
    ref_d, _ = reference.exact_knn(t_pts, t_q, got_d.shape[1], exclude=ex)
    safe = np.clip(got_i, 0, len(pts) - 1)
    at = reference.true_dists(t_pts, t_q, torch.from_numpy(safe))
    nums = compare.compare_rows(got_d, got_i, ref_d.numpy(), at.numpy(),
                                len(pts), exclude)
    return nums


def test_float32_answer_passes_and_control_fails():
    """The float32 answer (the reference's rounded to float32) is within
    the limits; the control in bfloat16 is not."""
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(4000, 3)) * 20).astype(np.float32)
    q = (rng.normal(size=(256, 3)) * 20).astype(np.float32)
    ref_d, ref_i = reference.exact_knn(torch.from_numpy(pts),
                                       torch.from_numpy(q), 8)
    good = _judge(pts, q, ref_d.float().numpy(), ref_i.numpy())
    assert compare.judge(good), good
    ctl_d, ctl_i = reference.control_knn(torch.from_numpy(pts),
                                         torch.from_numpy(q), 8)
    bad = _judge(pts, q, ctl_d.numpy(), ctl_i.numpy())
    assert not compare.judge(bad), bad
    assert bad["dist_rel_err"] > 100 * compare.LIMITS["dist_rel_err"]


@pytest.mark.parametrize("fault", ["next_row", "dup_index", "bad_index",
                                   "self_index", "short_list"])
def test_comparison_catches_a_wrong_answer(fault):
    pts = _cloud(11, 800, 2, dup=8)
    ids = np.arange(0, 800, 5)
    ref_d, ref_i = reference.exact_knn(
        torch.from_numpy(pts), torch.from_numpy(pts[ids]), 8,
        exclude=torch.from_numpy(ids))
    d, i = ref_d.float().numpy().copy(), ref_i.numpy().copy()
    assert compare.judge(_judge(pts, pts[ids], d, i, ids))
    if fault == "next_row":
        d, i = np.roll(d, 1, axis=0), np.roll(i, 1, axis=0)
    elif fault == "dup_index":
        i[3, 1] = i[3, 0]
    elif fault == "bad_index":
        i[3, 1] = len(pts)
    elif fault == "self_index":
        i[3, -1] = ids[3]
    else:
        d[3, -1] = np.inf
    assert not compare.judge(_judge(pts, pts[ids], d, i, ids))
