"""The data: derived seeds and generated clouds repeat, and the resident
cloud comes from its configuration's own draw."""

import numpy as np

from knnbench.datagen import derive_seed, make_cloud, make_points
from knnbench.spec import load_benchmark, resolve_cell


def test_derived_seeds_and_data_repeat():
    assert derive_seed(5, "cloud") == derive_seed(5, "cloud")
    assert derive_seed(5, "cloud") != derive_seed(5, "scan", 0)
    assert derive_seed(2**40, "x") != derive_seed(2**40 + 1, "x")
    a = make_points("lidar_like", 1000, derive_seed(9, "cloud"))
    assert a.shape == (1000, 3) and a.dtype == np.float32
    assert np.array_equal(a, make_points("lidar_like", 1000,
                                         derive_seed(9, "cloud")))
    r = make_points("roadlike", 1000, 1)
    assert r.shape == (1000, 2)


def test_cloud_comes_from_the_configuration_draw():
    bench = load_benchmark()
    a = resolve_cell(bench, "kitti-scan2map").config
    b = resolve_cell(bench, "kitti-scan2map-draw1").config
    assert a["cloud_seed"] != b["cloud_seed"]
    assert {k: v for k, v in a.items() if k not in ("name", "cloud_seed",
                                                     "assumed")} == {
        k: v for k, v in b.items() if k not in ("name", "cloud_seed",
                                                "assumed")}
    small = [dict(c, n_points=500) for c in (a, b)]
    assert np.array_equal(make_cloud(small[0]), make_cloud(small[0]))
    assert not np.array_equal(make_cloud(small[0]), make_cloud(small[1]))
