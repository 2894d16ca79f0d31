"""The port's examples (``repro_torch.examples``), twins of the repo's
``examples/``, at a small size on the CPU: what the originals check —
trueknn exact against the brute oracle, placed and served answers equal
to direct ones, warm batches that build no grid, a training run whose
loss falls, and kNN-LM retrieval that lowers the perplexity of seen
data."""

import contextlib
import io
import os

import numpy as np
import pytest

from repro_torch.examples import knnlm_serve, quickstart, serve_knn, train_lm


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


def test_train_lm_trains_and_checkpoints(tmp_path):
    hist, text = _run(train_lm.main, ["--preset", "smoke", "--steps", "30",
                                      "--device", "cpu", "--ckpt",
                                      str(tmp_path / "ck")])
    assert len(hist) == 30 and np.isfinite(hist).all()
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.2, text
    assert "last-10 loss" in text
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000030"]


def test_knnlm_serve_retrieval_lowers_seen_perplexity():
    res, text = _run(knnlm_serve.main, ["--device", "cpu"])
    assert np.isfinite(res["loss"]) and res["loss"] < 5.0, text
    assert set(res["knn"]) == {0.1, 0.25, 0.5}
    for lam, ppl in res["knn"].items():
        assert ppl < res["lm"], (lam, text)
    assert "LM-only perplexity" in text


@pytest.mark.parametrize("main", [quickstart.main, serve_knn.main])
def test_examples_default_to_the_card(main):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--n", "500"])


@pytest.mark.parametrize("main, argv", [
    (train_lm.main, ["--preset", "smoke", "--steps", "1"]),
    (knnlm_serve.main, []),
], ids=["train_lm", "knnlm_serve"])
def test_training_examples_default_to_the_card(main, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
