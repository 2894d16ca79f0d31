"""The port's examples (``repro_torch.examples``), twins of the repo's
``examples/quickstart.py`` and ``examples/serve_knn.py``, at a small size
on the CPU: what the originals check — trueknn exact against the brute
oracle, placed and served answers equal to direct ones, and warm batches
that build no grid."""

import contextlib
import io

import pytest

from repro_torch.examples import quickstart, serve_knn


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def test_quickstart_matches_the_brute_oracle():
    checks, text = _run(quickstart.main, ["--n", "2000", "--device", "cpu"])
    assert checks == {"exact_vs_brute": True, "warm_grid_builds": 0,
                      "warm_start": "warm", "placed_equals_monolith": True,
                      "graph_identical": True,
                      "served_cluster_equals_direct": True}, text
    assert "exact vs brute force: True" in text


def test_serve_knn_warm_batches_build_no_grid():
    res, text = _run(serve_knn.main, ["--n", "3000", "--batches", "3",
                                      "--batch-size", "64", "--device",
                                      "cpu"])
    first, *warm = res["timings"]
    assert first["grid_builds"] > 0 and first["start_radius_source"] == \
        "sampled"
    for tm in warm:
        assert tm["grid_builds"] == 0 and tm["grid_cache_hits"] > 0, text
        assert tm["start_radius_source"] == "warm"


@pytest.mark.parametrize("main", [quickstart.main, serve_knn.main])
def test_examples_default_to_the_card(main):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--n", "500"])
