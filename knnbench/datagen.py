"""The benchmark's data: the resident clouds and the query scans, made on
the host.

The three generators are frozen copies of ``repro_torch/core/datasets.py``
(the KITTI-, 3DRoad- and Porto-like families), so that a change to the
program cannot change what the benchmark feeds it.  A cloud that they do
not make is a file of its own, ``datasets/<name>.py`` with a ``make(n,
seed)``, found by the name a configuration gives as its ``dataset``.  The resident cloud
comes from its configuration's ``cloud_seed``; every other seed a
generator gets is derived from the run's ``--seed`` and a name, so every
scan and every sample of rows checked is an independent stream of one
seed.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from .spec import HERE, load_module

__all__ = ["GENERATORS", "derive_seed", "make_points", "make_cloud"]


def derive_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under the run's
    ``seed`` (any whole number; negative and large values are fine)."""
    words = [int(seed) % (1 << 64)]
    for key in keys:
        words.append(zlib.crc32(str(key).encode()) if isinstance(key, str)
                     else int(key) % (1 << 32))
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def clustered(n: int, d: int = 2, seed: int = 0, n_clusters: int = 64,
              outlier_frac: float = 0.001) -> np.ndarray:
    """Porto-like: dense clusters with lognormal scales and far outliers."""
    rng = np.random.default_rng(seed)
    n_out = max(1, int(n * outlier_frac))
    n_in = n - n_out
    centers = rng.uniform(0.0, 1.0, size=(n_clusters, d))
    scales = np.exp(rng.normal(-5.0, 1.0, size=n_clusters))
    weights = rng.dirichlet(np.full(n_clusters, 0.5))
    which = rng.choice(n_clusters, size=n_in, p=weights)
    pts = centers[which] + rng.normal(size=(n_in, d)) * scales[which, None]
    out = rng.uniform(-4.0, 5.0, size=(n_out, d))
    return np.concatenate([pts, out]).astype(np.float32)


def roadlike(n: int, seed: int = 0, n_roads: int = 200) -> np.ndarray:
    """3DRoad-like 2-D: points sampled densely along random polylines."""
    rng = np.random.default_rng(seed)
    pts = []
    per = max(8, n // n_roads)
    remaining = n
    for _ in range(n_roads):
        m = min(per, remaining)
        if m <= 0:
            break
        start = rng.uniform(0, 1, size=2)
        angle = rng.uniform(0, 2 * np.pi)
        length = rng.uniform(0.05, 0.4)
        t = np.sort(rng.uniform(0, 1, size=m))
        base = start + np.outer(t * length, [np.cos(angle), np.sin(angle)])
        jitter = rng.normal(scale=2e-4, size=(m, 2))
        pts.append(base + jitter)
        remaining -= m
    if remaining > 0:
        pts.append(rng.uniform(0, 1, size=(remaining, 2)))
    return np.concatenate(pts).astype(np.float32)[:n]


def lidar_like(n: int, seed: int = 0) -> np.ndarray:
    """KITTI-like 3-D: a ground-plane ring sweep, vertical structures and
    sparse far returns."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.7)
    n_wall = int(n * 0.25)
    n_far = n - n_ground - n_wall
    ang = rng.uniform(0, 2 * np.pi, n_ground)
    rr = np.abs(rng.gamma(2.0, 8.0, n_ground))
    ground = np.stack(
        [rr * np.cos(ang), rr * np.sin(ang), rng.normal(0, 0.05, n_ground)], 1
    )
    wx = rng.uniform(-30, 30, n_wall)
    wy = rng.choice([-8.0, 8.0], n_wall) + rng.normal(0, 0.2, n_wall)
    wz = rng.uniform(0, 4, n_wall)
    wall = np.stack([wx, wy, wz], 1)
    far = rng.uniform(-120, 120, size=(max(n_far, 0), 3))
    return np.concatenate([ground, wall, far]).astype(np.float32)[:n]


#: generator name (as a configuration's ``dataset`` names it) -> (n, seed)
#: -> (n, dim) float32
GENERATORS = {
    "lidar_like": lambda n, seed: lidar_like(n, seed),
    "roadlike": lambda n, seed: roadlike(n, seed),
    "clustered": lambda n, seed: clustered(n, 2, seed),
}


def make_points(dataset: str, n: int, seed: int,
                home: Path = HERE) -> np.ndarray:
    """``n`` points of the cloud ``dataset`` from ``seed``: a generator of
    ``GENERATORS``, else the ``make`` of ``<home>/datasets/<dataset>.py``
    (``FileNotFoundError``, naming the files found, where neither is)."""
    if dataset in GENERATORS:
        return GENERATORS[dataset](int(n), int(seed))
    try:
        mod = load_module(home, "datasets", dataset)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{e}; generators: {sorted(GENERATORS)}"
                                ) from None
    return mod.make(int(n), int(seed))


def make_cloud(config: dict, home: Path = HERE) -> np.ndarray:
    """The configuration's resident cloud.  It is drawn from the
    configuration's own ``cloud_seed``, not from the run's seed: the cloud
    is the deployment's data set, as a file would be, and the run's seed
    draws the traffic.  (The work of a search depends on where the start
    radius that the program samples from the cloud puts the radius
    lattice, so a cloud drawn per run moved the rate up to 2x between
    seeds.)"""
    return make_points(config["dataset"], config["n_points"],
                       derive_seed(config["cloud_seed"], "cloud"), home)
