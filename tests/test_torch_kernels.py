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
from repro_torch.kernels.build import WIDE_LAUNCHES, launch_counts
from repro_torch.kernels.ops import pairwise_topk, topk_engine
from repro_torch.kernels.pairwise_topk import (
    MIN_SPAN,
    WORKSPACE_BYTES,
    choose_splits,
    pairwise_topk_cuda,
)
from repro_torch.kernels.ref import (
    merge_partial_topk,
    pairwise_dists,
    pairwise_topk_ref,
)

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


def _quantised(rng, shape, steps=6, scale=0.25):
    """Coordinates on a coarse grid (multiples of ``scale``): every
    difference, square and sum is exact in float32, so distances tie often
    and any two exact evaluations agree bit for bit."""
    return (rng.integers(0, steps, size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("k", [33, 64, 257])
@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_plain_wide_k_bitwise_equals_pallas_on_ties(k, metric):
    """k > 32 (the warp list's KPL > 1 on the card): the plain version
    against the Pallas kernel (interpret mode, as tests/test_kernels.py runs
    it here) on quantised points over two of its point tiles, where nearly
    every distance ties.  Exact arithmetic makes the values bitwise, so the
    lowest-index-first order is compared slot by slot, with self ids and a
    radius count."""
    from repro.kernels.ops import pairwise_topk as jax_pairwise_topk

    rng = np.random.default_rng(k + len(metric))
    p = _quantised(rng, (700, 3))
    ids = rng.choice(700, 24, replace=False).astype(np.int32)
    q = p[ids]
    q[::3] += np.float32(0.125)  # exact too; not the self points
    radius = 0.5
    got = pairwise_topk(q, p, k, radius=radius, query_ids=ids, metric=metric)
    want = jax_pairwise_topk(q, p, k, radius=radius, query_ids=ids,
                             metric=metric)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
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


@pytest.mark.parametrize("d", [3, 9, 12, 16])
def test_plain_l2diff_bitwise_equals_jax_diff_sum(d):
    """``l2diff`` (the placed fabric's squared-L2 form) is the reference's
    jitted ``sum(diff * diff, -1)`` bitwise at every d that XLA reduces in
    axis order, and its top-k the reference's ``lax.top_k`` order."""
    import jax
    import jax.numpy as jnp

    from repro.core.distributed import _slot_form_dists

    rng = np.random.default_rng(d)
    p = rng.normal(size=(512, d)).astype(np.float32)
    p[300:304] = p[7]  # exact ties: the lowest row first
    q = rng.normal(size=(64, d)).astype(np.float32)
    q[5] = p[7]
    want = np.asarray(jax.jit(lambda b, x: _slot_form_dists("sq_l2", b, x))(
        jnp.asarray(p), jnp.asarray(q)))
    got = pairwise_dists(torch.from_numpy(q), torch.from_numpy(p), "l2diff")
    assert np.array_equal(got.numpy(), want)
    neg, idx = jax.lax.top_k(-jnp.asarray(want), 9)
    d9, i9, _ = pairwise_topk_ref(torch.from_numpy(q), torch.from_numpy(p),
                                  9, metric="l2diff")
    assert np.array_equal(d9.numpy(), -np.asarray(neg))
    assert np.array_equal(i9.numpy(), np.asarray(idx))


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
    before = launch_counts()["pairwise_topk"], WIDE_LAUNCHES["pairwise_topk"]
    pairwise_topk(q, q, 1)  # CPU tensors: the plain version, no launch
    pairwise_topk(q, q, 40)
    assert (launch_counts()["pairwise_topk"],
            WIDE_LAUNCHES["pairwise_topk"]) == before


# -- on the card: the CUDA kernel against its plain version ----------------

CARD_CASES = [
    # (d, metric, k, radius, self ids)
    (2, "l2", 1, np.inf, False),
    (3, "l2", 8, 0.4, True),
    (16, "l2", 64, 6.0, True),
    (3, "l1", 300, 1.0, False),
    (3, "linf", 8, 0.3, True),
    (3, "cosine", 64, 0.02, False),
    # generic forms on the warp path (k <= 32) whose tiles hold a row count
    # that is not a multiple of 32, several tiles a range
    (5, "l1", 8, 1.0, False),
    (6, "linf", 32, 0.3, True),
    (16, "l2", 8, 6.0, True),
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


@needs_card
@pytest.mark.parametrize("d,k", [(3, 9), (12, 9), (12, 40), (20, 5)])
def test_cuda_l2diff_matches_plain(d, k):
    """The diff-form L2 selector on the card: bitwise the plain version at
    every d (one list entry a lane for k <= 32, two at k = 40), masked
    rows untouched."""
    rng = np.random.default_rng(d * k)
    dev = torch.device("cuda")
    p = torch.from_numpy(rng.normal(size=(3000, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(dev)
    qid = torch.full((500,), -1, dtype=torch.int32, device=dev)
    mask = (torch.arange(500, device=dev) % 4 != 1).to(torch.uint8)
    outs = []
    for fn in (topk_engine, None):
        out = (torch.full((500, k), -1.0, device=dev),
               torch.full((500, k), -1, dtype=torch.int32, device=dev),
               torch.full((500,), -1, dtype=torch.int32, device=dev))
        if fn is None:
            pairwise_topk_ref(q, p, k, radius2=float(d), query_ids=qid,
                              metric="l2diff", row_mask=mask, out=out)
        else:
            fn(q, qid, p, float(d), k=k, metric="l2diff", row_mask=mask,
               out=out)
        outs.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (outs[0][2][mask == 0] == -1).all()


# -- the split-N algorithm: partial lists over point ranges, then a merge ---


def _split_topk(q, p, k, bounds, *, thr=math.inf, qid=None, metric="l2",
                row_mask=None):
    """The kernel's first pass in plain PyTorch: ``pairwise_topk_ref`` on
    each range [lo, hi) of the points, indices made global, sentinel n."""
    n = p.shape[0]
    nq = q.shape[0]
    qid = torch.full((nq,), n, dtype=torch.int32) if qid is None else qid
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        local = torch.where((qid >= lo) & (qid < hi), qid - lo, hi - lo)
        d, i, c = pairwise_topk_ref(q, p[lo:hi], k, radius2=thr,
                                    query_ids=local.to(torch.int32),
                                    metric=metric, row_mask=row_mask)
        i = torch.where(i < hi - lo, i + lo, n).to(torch.int32)
        parts.append((d, i, c))
    return tuple(torch.stack(t) for t in zip(*parts))


SPLIT_CASES = [
    # (tag, n, d, k, metric, radius2, bounds of the split)
    ("dup ties across boundaries", 400, 3, 9, "l2", 0.8,
     (0, 100, 101, 250, 400)),
    ("split shorter than k", 300, 2, 12, "l2", math.inf, (0, 5, 150, 157, 300)),
    ("one split", 200, 3, 6, "l2", 0.5, (0, 200)),
    ("l1 self ids", 360, 3, 7, "l1", 1.0, (0, 90, 180, 270, 360)),
    ("linf many splits", 256, 2, 4, "linf", 0.3, tuple(range(0, 257, 16))),
    ("k 300", 900, 3, 300, "l2", 1.5, (0, 300, 450, 900)),
]


@pytest.mark.parametrize("tag,n,d,k,metric,thr,bounds", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("masked", [False, True])
def test_merge_of_splits_equals_unsplit(tag, n, d, k, metric, thr, bounds,
                                        masked):
    """Partial lists over contiguous ranges, merged in range order, are the
    unsplit list bitwise: values, indices (lowest first on ties, also
    across a boundary), counts, and untouched unmasked rows."""
    rng = np.random.default_rng(n + k + d)
    p = rng.normal(size=(n, d)).astype(np.float32)
    # exact duplicates of point 3 on both sides of every boundary
    for b in bounds[1:-1]:
        p[b - 1] = p[3]
        p[b] = p[3]
    p = torch.from_numpy(p)
    nq = 37
    ids = rng.choice(n, nq, replace=False)
    ids[0], ids[1] = bounds[1] - 1, bounds[-2]  # self ids at both sides
    qid = torch.from_numpy(ids.astype(np.int32))
    q = p[qid.long()].clone()
    q[5:] += torch.from_numpy(rng.normal(scale=0.05, size=(nq - 5, d))
                              .astype(np.float32))
    q[7] = p[3]  # a query whose nearest points tie across every boundary
    mask = (torch.from_numpy((np.arange(nq) % 3 != 1).astype(np.uint8))
            if masked else None)
    want = tuple(t.clone() for t in (
        torch.full((nq, k), -1.0), torch.full((nq, k), -1, dtype=torch.int32),
        torch.full((nq,), -1, dtype=torch.int32)))
    pairwise_topk_ref(q, p, k, radius2=thr, query_ids=qid, metric=metric,
                      row_mask=mask, out=want)
    part = _split_topk(q, p, k, bounds, thr=thr, qid=qid, metric=metric,
                       row_mask=mask)
    got = tuple(t.clone() for t in (
        torch.full((nq, k), -1.0), torch.full((nq, k), -1, dtype=torch.int32),
        torch.full((nq,), -1, dtype=torch.int32)))
    merge_partial_topk(*part, k, n, row_mask=mask, out=got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not (got[1] == qid[:, None]).any()
    if masked:
        assert (got[2][mask == 0] == -1).all()


def test_merge_keeps_lowest_index_on_cross_range_ties():
    """Every point equidistant from the query: the merged list is the k
    lowest indices, whatever range each came from."""
    p = torch.zeros((50, 2))
    q = torch.ones((1, 2))
    bounds = (0, 7, 8, 30, 50)
    part = _split_topk(q, p, 10, bounds)
    d, i, c = merge_partial_topk(*part, 10, 50)
    assert torch.equal(i[0], torch.arange(10, dtype=torch.int32))
    assert (d == 2.0).all() and c.item() == 50


@pytest.mark.parametrize("ranges", [64, 528])
def test_merge_of_many_ranges_equals_unsplit(ranges):
    """The shape the warp-a-row merge serves: one query, k = 256, its points
    cut into S >= 64 ranges (528 = 4 blocks on each of 132 SMs, as
    ``choose_splits`` fans a single-row call out), most ranges shorter than
    k, tie-heavy quantised points with duplicates at every boundary.  The
    merged lists are the unsplit plain version's bitwise."""
    rng = np.random.default_rng(ranges)
    n, k = 30 * ranges + 17, 256
    p = _quantised(rng, (n, 3), steps=8)
    bounds = tuple(np.linspace(0, n, ranges + 1).astype(int))
    for b in bounds[1:-1]:
        p[b - 1] = p[0]
        p[b] = p[0]
    p = torch.from_numpy(p)
    q = p[:1].clone()
    qid = torch.tensor([n], dtype=torch.int32)
    want = pairwise_topk_ref(q, p, k, radius2=0.25, query_ids=qid)
    part = _split_topk(q, p, k, bounds, thr=0.25, qid=qid)
    assert part[0].shape[0] == ranges
    got = merge_partial_topk(*part, k, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nq,n,k,per_block", [
    # per_block: the first pass's rows a block (four warps of 4, 2 or 1
    # queries: 16 for L2 at d = 2, 3 and k <= 256, 8 at k <= 512, 4 at
    # k > 512 and for the other forms; 128 was the first port's one thread
    # a query at k > 32)
    (100, 1 << 20, 5, 16), (4096, 1 << 20, 32, 16), (512, 1 << 20, 300, 128),
    (777, 5000, 8, 4), (1, 3, 1, 16), (1 << 20, 1 << 20, 8, 16),
    (4096, 1 << 20, 4096, 128), (512, 1 << 16, 64, 128),
    (512, 1 << 20, 300, 8), (512, 1 << 16, 64, 16),
    # k > 32 on the warp list: a single-row request and eight rows fan out
    # to hundreds of ranges; the escalation slot (L1, 4005 rows) and a
    # k = 1024 self-query fill the card with S = 1
    (1, 1 << 20, 256, 16), (8, 1 << 20, 256, 16), (4096, 1 << 17, 128, 4),
    (4096, 1 << 20, 1024, 4), (4096, 1 << 20, 128, 16),
    (4096, 1 << 20, 4096, 4), (512, 1 << 20, 1100, 4),
])
def test_choose_splits_covers_the_points(nq, n, k, per_block):
    """Ranges tile [0, N) with none empty; the sampler's call fans out to
    several blocks per SM; the workspace stays within its budget."""
    sms = 132
    s, span = choose_splits(nq, n, k, sms, per_block)
    assert s >= 1 and (s - 1) * span < n <= s * span
    tiles = -(-nq // per_block)
    if s > 1:
        assert s * nq * k * 8 <= WORKSPACE_BYTES
        assert span >= MIN_SPAN
    if (nq, n) == (100, 1 << 20):
        assert tiles * s >= 4 * sms
    if tiles >= 4 * sms:
        assert s == 1
    if nq <= 8 and k == 256:
        assert s >= 100  # the merge of hundreds of lists a row


@needs_card
@pytest.mark.parametrize("nq,n,k,thr", [
    (100, 200_000, 5, math.inf), (300, 60_000, 300, 0.5), (777, 5000, 32, 0.4),
])
def test_cuda_split_kernel_matches_plain(nq, n, k, thr):
    """The split first pass and the merge kernel against the plain version
    on the card, with duplicates across the kernel's own range bounds and
    an all-zero row_mask that must leave every output untouched."""
    from repro_torch.kernels.pairwise_topk import split_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(n + k)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    s, span = split_plan(nq, n, 3, k, "l2", dev)
    assert s > 1
    for b in range(span, n, span):
        p[b - 1] = p[0]
        p[b] = p[0]
    p = torch.from_numpy(p).to(dev)
    q = p[:nq].clone()
    qid = torch.arange(nq, dtype=torch.int32, device=dev)
    got = pairwise_topk_cuda(q, qid, p, thr, k=k)
    want = pairwise_topk_ref(q, p, k, radius2=thr, query_ids=qid)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    zero = torch.zeros(nq, dtype=torch.uint8, device=dev)
    out = (torch.full((nq, k), -1.0, device=dev),
           torch.full((nq, k), -1, dtype=torch.int32, device=dev),
           torch.full((nq,), -1, dtype=torch.int32, device=dev))
    pairwise_topk_cuda(q, qid, p, thr, k=k, row_mask=zero, out=out)
    torch.cuda.synchronize()
    for o in out:
        assert (o == -1).all()


# -- on the card: k > 32, the warp list and the merge of many ranges --------

WIDE_FORMS = [(3, "l2"), (2, "l2"), (3, "l1"), (3, "linf"), (5, "l1"),
              (16, "l2"), (12, "l2diff")]


@needs_card
@pytest.mark.parametrize("k", [33, 64, 128, 256, 1024, 1100, 3000])
@pytest.mark.parametrize("d,metric", WIDE_FORMS)
def test_cuda_wide_k_matches_plain(d, metric, k):
    """Every register-list size (32 * KPL = 64 ... 1024) and the row list
    above it, in every distance form, against the plain version on
    the card, bitwise: quantised points (exact distances, so the identity
    form at d = 16 is exact too) with 40 copies of one point, which tie
    inside a 32-point chunk and across chunks, on the split path; self
    ids; a row_mask whose other rows stay untouched."""
    from repro_torch.kernels.pairwise_topk import split_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(k * 31 + d)
    n, nq = 6000, 300
    p = _quantised(rng, (n, d), steps=8)
    p[1000:1040] = p[7]
    p = torch.from_numpy(p).to(dev)
    qid = torch.arange(0, 2 * nq, 2, dtype=torch.int32, device=dev)
    q = p[qid.long()].contiguous()
    q[1] = p[7]
    mask = (torch.arange(nq, device=dev) % 5 != 2).to(torch.uint8)
    thr = 0.25 * d
    assert split_plan(nq, n, d, k, metric, dev)[0] > 1
    wide = WIDE_LAUNCHES["pairwise_topk"]
    outs = []
    for kernel in (True, False):
        out = (torch.full((nq, k), -1.0, device=dev),
               torch.full((nq, k), -1, dtype=torch.int32, device=dev),
               torch.full((nq,), -1, dtype=torch.int32, device=dev))
        if kernel:
            topk_engine(q, qid, p, thr, k=k, metric=metric, row_mask=mask,
                        out=out)
        else:
            pairwise_topk_ref(q, p, k, radius2=thr, query_ids=qid,
                              metric=metric, row_mask=mask, out=out)
        outs.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (outs[0][2][mask == 0] == -1).all()
    assert WIDE_LAUNCHES["pairwise_topk"] == wide + 1  # counted apart


@needs_card
@pytest.mark.parametrize("nq", [1, 8])
def test_cuda_many_range_merge_matches_plain(nq):
    """A single-row and an eight-row call at k = 256 on 2^20 points, which
    the split fans out to hundreds of ranges: the whole call, and the merge
    kernel alone on the first pass's partial lists, also
    under a row_mask, against the plain versions, bitwise, with duplicates
    across the kernel's own range bounds."""
    from repro_torch.kernels.build import extension
    from repro_torch.kernels.pairwise_topk import split_plan

    dev = torch.device("cuda")
    n, k = 1 << 20, 256
    rng = np.random.default_rng(nq)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    s, span = split_plan(nq, n, 3, k, "l2", dev)
    assert s >= 100
    for b in range(span, n, span):
        p[b - 1] = p[0]
        p[b] = p[0]
    p = torch.from_numpy(p).to(dev)
    q = p[:nq].clone()
    qid = torch.full((nq,), n, dtype=torch.int32, device=dev)
    got = pairwise_topk_cuda(q, qid, p, 0.01, k=k)
    want = pairwise_topk_ref(q, p, k, radius2=0.01, query_ids=qid)
    part = (torch.empty((s, nq, k), device=dev),
            torch.empty((s, nq, k), dtype=torch.int32, device=dev),
            torch.empty((s, nq), dtype=torch.int32, device=dev))
    extension().pairwise_topk(q, qid, p, None, k, s, span, 0.01, 0, *part)
    merged = tuple(torch.empty_like(t) for t in got)
    extension().pairwise_topk_merge(*part, None, n, *merged)
    plain = merge_partial_topk(*part, k, n)
    # a row_mask: the other rows' outputs stay as they were
    mask = (torch.arange(nq, device=dev) % 3 != 1).to(torch.uint8)
    masked = [tuple(torch.full_like(t, -1) for t in got) for _ in range(2)]
    extension().pairwise_topk_merge(*part, mask, n, *masked[0])
    merge_partial_topk(*part, k, n, row_mask=mask, out=masked[1])
    torch.cuda.synchronize()
    for g, w, m, pm, a, b in zip(got, want, merged, plain, *masked):
        assert torch.equal(g, w)
        assert torch.equal(m, pm)
        assert torch.equal(a, b)
