"""The port's pairwise_topk engine against the JAX package.

On the CPU the port runs the kernel's plain PyTorch version; it is held
against the Pallas kernel (interpret mode) on the reference kernel test's
contract (tests/test_kernels.py: distances rtol 1e-4 / atol 1e-5, index
sets compared by distance, counts exact), and the brute engine built on
it must equal ``repro``'s brute engine bitwise for L2 (d <= 8), L1 and
L∞.  The CUDA kernel itself is held against the plain version on the
card only (the card tests skip here).  The JAX package is imported inside
the parity tests, so the card tests also run where JAX is not installed.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.brute import brute_knn_engine
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.ops import pairwise_topk, topk_engine
from repro_torch.kernels.pairwise_topk import pairwise_topk_cuda
from repro_torch.kernels.ref import pairwise_topk_ref

torch.set_num_threads(1)

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card"
)


def jax_brute(*args, **kw):
    from repro.core.brute import brute_knn_engine as ref

    return ref(*args, **kw)


def _dist64(metric, q, p):
    diff = q.astype(np.float64)[None, :] - p.astype(np.float64)
    if metric == "l1":
        return np.abs(diff).sum(-1)
    if metric == "linf":
        return np.abs(diff).max(-1)
    if metric == "cosine":
        qn = q / max(np.linalg.norm(q), 1e-12)
        pn = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-12)
        return 1.0 - pn.astype(np.float64) @ qn.astype(np.float64)
    return (diff * diff).sum(-1)


def _check_contract(metric, q, p, got, want):
    """tests/test_kernels.py's contract: allclose distances, exact counts,
    index sets equal by distance value."""
    (gd, gi, gc), (wd, wi, wc) = got, want
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(gc, wc)
    n = p.shape[0]
    for r in range(q.shape[0]):
        g = np.sort(_dist64(metric, q[r], p[gi[r][gi[r] < n]]))
        w = np.sort(_dist64(metric, q[r], p[wi[r][wi[r] < n]]))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


CASES = [
    # (nq, n, d, k, metric, radius, self ids)
    (17, 300, 2, 5, "l2", 0.5, False),
    (40, 257, 3, 8, "l2", np.inf, True),
    (24, 200, 16, 6, "l2", 5.0, False),
    (33, 300, 3, 7, "l1", 1.0, True),
    (20, 150, 2, 4, "linf", 0.4, False),
    (16, 120, 3, 9, "cosine", 0.05, True),
]


@pytest.mark.parametrize("nq,n,d,k,metric,radius,selfids", CASES)
def test_plain_pairwise_topk_matches_pallas(nq, n, d, k, metric, radius,
                                            selfids):
    from repro.kernels.ops import pairwise_topk as jax_pairwise_topk

    rng = np.random.default_rng(nq * 7 + n + d)
    p = rng.normal(size=(n, d)).astype(np.float32)
    if selfids:
        ids = rng.choice(n, nq, replace=False).astype(np.int32)
        q = p[ids]
    else:
        ids = None
        q = rng.normal(size=(nq, d)).astype(np.float32)
    got = pairwise_topk(q, p, k, radius=radius, query_ids=ids, metric=metric)
    want = jax_pairwise_topk(q, p, k, radius=radius, query_ids=ids,
                             metric=metric)
    _check_contract(
        metric, q, p,
        [t.numpy() for t in got], [np.asarray(t) for t in want],
    )
    if ids is not None:
        assert not (got[1].numpy() == ids[:, None]).any()


@pytest.mark.parametrize("metric,d", [
    ("l2", 2), ("l2", 3), ("l2", 8), ("l1", 2), ("l1", 3), ("linf", 3),
])
@pytest.mark.parametrize("self_query", [True, False])
def test_plain_brute_bitwise_equals_jax(metric, d, self_query):
    """The brute engine on the plain version reproduces the reference's
    float forms exactly: values AND tie order."""
    rng = np.random.default_rng(d * 13 + len(metric))
    p = rng.normal(size=(700, d)).astype(np.float32)
    p[350:360] = p[0]  # exact ties: lowest index must come first
    q = None if self_query else rng.normal(size=(61, d)).astype(np.float32)
    got_d, got_i, got_t = brute_knn_engine(torch.from_numpy(p), 12,
                                           queries=q, metric=metric)
    want_d, want_i, want_t = jax_brute(p, 12, queries=q, metric=metric)
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_t == want_t


def test_plain_brute_cosine_and_highd_close():
    rng = np.random.default_rng(5)
    p = rng.normal(size=(400, 12)).astype(np.float32)
    q = rng.normal(size=(30, 12)).astype(np.float32)
    for metric in ("cosine", "l2"):
        gd, gi, _ = brute_knn_engine(torch.from_numpy(p), 6, queries=q,
                                     metric=metric)
        wd, wi, _ = jax_brute(p, 6, queries=q, metric=metric)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4,
                                   atol=1e-6)


def test_row_mask_writes_only_masked_rows():
    """The masked form the fused loop's brute tail uses: unmasked rows of
    ``out`` stay as they were, masked rows equal a full run."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    qid = torch.full((40,), 300, dtype=torch.int32)
    full = pairwise_topk_ref(q, p, 5, query_ids=qid)
    mask = torch.from_numpy((np.arange(40) % 3 == 0).astype(np.uint8))
    out = (torch.full((40, 5), -1.0), torch.full((40, 5), -1, dtype=torch.int32),
           torch.full((40,), -1, dtype=torch.int32))
    topk_engine(q, qid, p, math.inf, k=5, row_mask=mask, out=out)
    m = mask.bool()
    for o, f in zip(out, full):
        assert torch.equal(o[m], f[m])
        assert (o[~m] == -1).all()


def test_k_beyond_points_pads_with_sentinel():
    p = torch.zeros((4, 2))
    q = torch.ones((3, 2))
    d, i, c = pairwise_topk(q, p, 7)
    assert torch.isinf(d[:, 4:]).all() and (i[:, 4:] == 4).all()
    assert (c == 4).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never falls back to the
    plain version (the dispatch by device lives in topk_engine)."""
    q = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        pairwise_topk_cuda(q, torch.zeros(2, dtype=torch.int32), q, 1.0, k=1)
    before = launch_counts()["pairwise_topk"]
    pairwise_topk(q, q, 1)  # CPU tensors: the plain version, no launch
    assert launch_counts()["pairwise_topk"] == before


# -- on the card: the CUDA kernel against its plain version ----------------

CARD_CASES = [
    # (d, metric, k, radius, self ids)
    (2, "l2", 1, np.inf, False),
    (3, "l2", 8, 0.4, True),
    (16, "l2", 64, 6.0, True),
    (3, "l1", 300, 1.0, False),
    (3, "linf", 8, 0.3, True),
    (3, "cosine", 64, 0.02, False),
]


@needs_card
@pytest.mark.parametrize("d,metric,k,radius,selfids", CARD_CASES)
def test_cuda_kernel_matches_plain(d, metric, k, radius, selfids):
    rng = np.random.default_rng(d + k)
    dev = torch.device("cuda")
    p = torch.from_numpy(rng.normal(size=(5000, d)).astype(np.float32)).to(dev)
    ids = torch.arange(777, dtype=torch.int32, device=dev) if selfids else None
    q = p[:777].clone() if selfids else torch.from_numpy(
        rng.normal(size=(777, d)).astype(np.float32)).to(dev)
    got = pairwise_topk(q, p, k, radius=radius, query_ids=ids, metric=metric)
    qq, pp = q, p
    if metric == "cosine":
        from repro_torch.kernels.ops import l2_normalize

        qq, pp = l2_normalize(q), l2_normalize(p)
    thr = {"l2": float(np.float32(radius) ** 2) if np.isfinite(radius)
           else math.inf, "cosine": 2.0 * min(radius, 2.0)}.get(metric, radius)
    qid = ids if ids is not None else torch.full((777,), 5000,
                                                 dtype=torch.int32, device=dev)
    want = pairwise_topk_ref(qq, pp, k, radius2=thr, query_ids=qid,
                             metric="l2" if metric == "cosine" else metric)
    if metric == "cosine":
        want = (want[0] * 0.5, want[1], want[2])
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    if d <= 8 or metric != "l2":
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
