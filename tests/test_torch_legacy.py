"""The deprecated entry forms of the port against the JAX package's:
``trueknn()`` / ``TrueKNNResult``, ``brute_knn``, ``fixed_radius_knn`` and
``NeighborIndex.query(queries, k, radius=..., stop_radius=...)``.

The same seeded clouds go through both packages (the port with
``device="cpu"``, its kernels' plain versions) and every answer, count and
round must be ``np.array_equal``; the port's warn-once registry and its
caller attribution are held to the reference's contract
(``tests/test_query.py``'s deprecation cases).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.api.query as ref_query
import repro.core as ref_core
import repro_torch.api.query as port_query
import repro_torch.core as port_core
from repro_torch import KnnSpec, build_index, make_dataset
from torch_trueknn_cases import assert_same

torch.set_num_threads(1)

PTS = make_dataset("porto", 400, seed=4)
QS = make_dataset("porto", 32, seed=11)
KITTI = make_dataset("kitti", 500, seed=2)
KQS = make_dataset("kitti", 32, seed=12)


@pytest.fixture(autouse=True)
def _fresh_registries():
    port_query._reset_deprecation_registry()
    ref_query._reset_deprecation_registry()
    yield
    port_query._reset_deprecation_registry()
    ref_query._reset_deprecation_registry()


def _quiet(fn, *args, **kwargs):
    """Call ``fn`` with deprecation warnings ignored (parity tests)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def _radius(pts, qs, k, pct=60.0):
    d = np.sqrt(((qs[:, None, :].astype(np.float64) - pts[None]) ** 2)
                .sum(-1))
    return float(np.percentile(np.sort(d, 1)[:, k - 1], pct))


# -- the deprecation contract (tests/test_query.py's cases, on the port) ----


def test_legacy_query_k_warns_once_and_matches_spec_path():
    index = build_index(PTS, backend="trueknn", device="cpu")
    want = index.query(QS, KnnSpec(4))
    with pytest.warns(DeprecationWarning, match="KnnSpec"):
        legacy = index.query(QS, 4)
    # once per process: the second legacy call must stay silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        legacy2 = index.query(QS, k=4)
    for got in (legacy, legacy2):
        assert np.array_equal(got.dists, want.dists)
        assert np.array_equal(got.idxs, want.idxs)


def test_free_function_shims_warn_once_and_match_spec_path():
    pts, qs = PTS, QS
    with pytest.warns(DeprecationWarning, match="trueknn\\(\\) is deprecated"):
        res = port_core.trueknn(pts, 3, queries=qs, device="cpu")
    want = build_index(pts, backend="trueknn", device="cpu").query(
        qs, KnnSpec(3))
    assert_same(res, want)

    with pytest.warns(DeprecationWarning, match="brute_knn\\(\\) is deprecated"):
        d, i, t = port_core.brute_knn(pts, 3, queries=qs, device="cpu")
    brute = build_index(pts, backend="brute", device="cpu").query(
        qs, KnnSpec(3))
    assert np.array_equal(d, brute.dists) and np.array_equal(i, brute.idxs)
    assert t == brute.n_tests

    r = _radius(pts, qs, 3)
    with pytest.warns(DeprecationWarning, match="fixed_radius_knn\\(\\) is"):
        port_core.fixed_radius_knn(pts, r, 3, queries=qs, device="cpu")

    # all three keys now recorded: everything stays silent from here on
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_core.trueknn(pts, 3, queries=qs, device="cpu")
        port_core.brute_knn(pts, 3, queries=qs, device="cpu")
        port_core.fixed_radius_knn(pts, r, 3, queries=qs, device="cpu")


def test_deprecation_warnings_point_at_the_caller_not_the_shim():
    """The warning's recorded location is the migrating caller's frame —
    this file — for every deprecated entry point, also when the form is
    reached through a frame inside the ``repro_torch`` package."""
    index = build_index(PTS, backend="brute", device="cpu")

    def _warning_file(fn, *args, **kwargs):
        port_query._reset_deprecation_registry()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn(*args, **kwargs)
        dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert dep, "no DeprecationWarning fired"
        return dep[0].filename

    assert _warning_file(index.query, QS, 3) == __file__
    assert _warning_file(port_core.trueknn, PTS, 3, queries=QS,
                         device="cpu") == __file__
    assert _warning_file(port_core.brute_knn, PTS, 3, queries=QS,
                         device="cpu") == __file__
    assert _warning_file(port_core.fixed_radius_knn, PTS, 0.5, 3,
                         queries=QS, device="cpu") == __file__

    # a wrapper whose code object lives inside the package: the stack walk
    # must skip past it to this file (a fixed stacklevel stops on it)
    code = compile(
        "def _pkg_wrapper(fn, *a, **k):\n    return fn(*a, **k)\n",
        port_query.__file__,
        "exec",
    )
    ns: dict = {}
    exec(code, ns)
    assert _warning_file(ns["_pkg_wrapper"], index.query, QS, 3) == __file__
    # the reference's package root is not the port's: a wrapper compiled
    # there is the caller as far as the port's walk is concerned
    code = compile(
        "def _ref_wrapper(fn, *a, **k):\n    return fn(*a, **k)\n",
        ref_query.__file__,
        "exec",
    )
    exec(code, ns)
    assert _warning_file(ns["_ref_wrapper"], index.query, QS,
                         3) == ref_query.__file__


def test_warn_deprecated_once_is_exported_and_keyed():
    assert "warn_deprecated_once" in port_query.__all__
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        port_query.warn_deprecated_once("a", "first a")
        port_query.warn_deprecated_once("a", "second a")
        port_query.warn_deprecated_once("b", "first b", stacklevel=1)
    assert [str(x.message) for x in w] == ["first a", "first b"]
    assert all(x.category is DeprecationWarning for x in w)
    assert port_query._WARNED == {"a", "b"}


@pytest.mark.parametrize("args,kwargs,match", [
    (("spec",), {"k": 3}, "not both"),
    (("spec",), {"radius": 0.5}, "not both"),
    (("knn",), {}, "QuerySpec"),
    ((), {}, "needs a QuerySpec"),
    ((3,), {"k": 4}, "k twice"),
])
def test_query_rejects_mixed_and_bad_args(args, kwargs, match):
    msgs = []
    for idx, spec in ((build_index(PTS, backend="brute", device="cpu"),
                       KnnSpec(3)),
                      (ref_api.build_index(PTS, backend="brute"),
                       ref_api.KnnSpec(3))):
        call = [spec if a == "spec" else a for a in args]
        with pytest.raises(TypeError, match=match) as err:
            idx.query(QS, *call, **kwargs)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]  # the reference's wording


# -- shim compatibility (tests/test_api.py's cases, on the port) ------------


def test_legacy_trueknn_result_surface():
    pts = make_dataset("uniform", 400, seed=1)
    res = _quiet(port_core.trueknn, pts, 4, device="cpu")
    assert port_core.TrueKNNResult is port_core.KNNResult
    assert isinstance(res, port_core.TrueKNNResult)  # alias of KNNResult
    assert res.total_tests == res.n_tests > 0
    assert res.n_rounds == len(res.rounds) >= 1
    assert res.total_seconds > 0
    mod = importlib.import_module("repro_torch.core.trueknn")
    assert mod.__all__ == importlib.import_module(
        "repro.core.trueknn").__all__
    assert mod.__all__ == ["trueknn", "TrueKNNResult", "RoundStats"]
    assert mod.RoundStats is port_core.RoundStats


def test_legacy_fixed_radius_tuple_shape():
    pts = make_dataset("uniform", 400, seed=1)
    r = port_core.max_knn_distance(pts, 3, device="cpu") * 1.0001
    d, i, f, t = _quiet(port_core.fixed_radius_knn, pts, r, 3, device="cpu")
    assert d.shape == (400, 3) and i.shape == (400, 3)
    assert np.all(np.asarray(f) >= 3) and t > 0


def test_shims_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for fn, args in ((port_core.trueknn, (PTS, 3)),
                     (port_core.brute_knn, (PTS, 3)),
                     (port_core.fixed_radius_knn, (PTS, 0.5, 3))):
        with pytest.raises(RuntimeError, match="cuda"):
            _quiet(fn, *args)


# -- parity with the JAX package --------------------------------------------


@pytest.mark.parametrize("case", ["self", "queries", "start_radius",
                                  "stop_radius", "kitti_growth"])
def test_trueknn_equals_reference(case):
    pts, kw = PTS, {}
    if case != "self":
        kw["queries"] = QS
    if case == "start_radius":
        kw["start_radius"] = 0.05
    if case == "stop_radius":
        kw["stop_radius"] = _radius(PTS, QS, 4, 30.0)
    if case == "kitti_growth":
        pts, kw = KITTI, {"growth": 1.5, "max_rounds": 6, "chunk": 128,
                          "seed": 3}
    want = _quiet(ref_core.trueknn, pts, 4, **kw)
    got = _quiet(port_core.trueknn, pts, 4, device="cpu", **kw)
    assert isinstance(got, port_core.TrueKNNResult)
    assert_same(got, want)
    assert got.n_tests < 1 << 24


@pytest.mark.parametrize("queries", [None, "qs"])
@pytest.mark.parametrize("k", [1, 6])
def test_brute_knn_equals_reference(queries, k):
    qs = KQS if queries else None
    wd, wi, wt = _quiet(ref_core.brute_knn, KITTI, k, queries=qs, chunk=64)
    gd, gi, gt = _quiet(port_core.brute_knn, KITTI, k, queries=qs, chunk=64,
                        device="cpu")
    assert np.array_equal(gd, np.asarray(wd))
    assert np.array_equal(gi, np.asarray(wi))
    assert gt == wt


@pytest.mark.parametrize("queries", [None, "qs"])
@pytest.mark.parametrize("pct", [20.0, 80.0])
def test_fixed_radius_knn_equals_reference(queries, pct):
    qs = QS if queries else None
    r = _radius(PTS, QS, 5, pct)
    want = _quiet(ref_core.fixed_radius_knn, PTS, r, 5, queries=qs)
    got = _quiet(port_core.fixed_radius_knn, PTS, r, 5, queries=qs,
                 device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got[3] == want[3]


@pytest.mark.parametrize("form", ["positional", "keyword", "radius",
                                  "stop_radius"])
def test_legacy_query_equals_reference(form):
    r = _radius(PTS, QS, 4, 40.0)
    args, kwargs = {
        "positional": ((4,), {}),
        "keyword": ((), {"k": 4}),
        "radius": ((4,), {"radius": r}),
        "stop_radius": ((), {"k": 4, "stop_radius": r}),
    }[form]
    port = build_index(PTS, backend="trueknn", device="cpu")
    ref = ref_api.build_index(PTS, backend="trueknn")
    for _ in range(2):  # a sampled batch, then a warm one
        got = _quiet(port.query, QS, *args, **kwargs)
        want = _quiet(ref.query, QS, *args, **kwargs)
        assert_same(got, want)


def test_legacy_query_on_brute_and_fixed_radius_equal_reference():
    """The legacy form adapts to ``KnnSpec`` on every backend, so a
    brute or fixed_radius index answers it as the reference does."""
    r = _radius(PTS, QS, 4, 60.0)
    for backend, cfg in (("brute", {}), ("fixed_radius", {"radius": r})):
        port = build_index(PTS, backend=backend, device="cpu", **cfg)
        ref = ref_api.build_index(PTS, backend=backend, **cfg)
        got = _quiet(port.query, QS, 4)
        want = _quiet(ref.query, QS, 4)
        assert np.array_equal(got.dists, want.dists)
        assert np.array_equal(got.idxs, want.idxs)
        assert got.n_tests == want.n_tests
        spec = port.query(QS, KnnSpec(4))
        assert np.array_equal(got.idxs, spec.idxs)
