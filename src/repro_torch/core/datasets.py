"""Synthetic dataset families mirroring the paper's evaluation datasets.

The paper evaluates on 2D road-network data (3DRoad), heavy-tailed 2D GPS
trajectories (Porto), 3D LiDAR (KITTI), 3D ionosphere measurements (3DIono)
and a uniform 3D control (UniformDist).  The real files are not shipped here;
what matters for the paper's claims is the *density structure* — clusters,
heavy tails and outliers are what make TrueKNN beat the oracle fixed radius.
Each generator reproduces the relevant structure deterministically.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "DATASETS"]


def uniform(n: int, d: int = 3, seed: int = 0) -> np.ndarray:
    """Paper's UniformDist control: uniform on [0,1]^d (worst case for TrueKNN)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(n, d)).astype(np.float32)


def clustered(
    n: int,
    d: int = 2,
    seed: int = 0,
    n_clusters: int = 64,
    outlier_frac: float = 0.001,
) -> np.ndarray:
    """Porto-like: dense urban clusters with lognormal scales + far outliers.

    GPS trajectory data is extremely heavy-tailed — most points sit in dense
    street clusters; a tiny fraction (sensor glitches / highway stretches) are
    far away.  These outliers are exactly what forces the paper's baseline to
    a huge oracle radius.
    """
    rng = np.random.default_rng(seed)
    n_out = max(1, int(n * outlier_frac))
    n_in = n - n_out
    centers = rng.uniform(0.0, 1.0, size=(n_clusters, d))
    scales = np.exp(rng.normal(-5.0, 1.0, size=n_clusters))  # lognormal widths
    weights = rng.dirichlet(np.full(n_clusters, 0.5))
    which = rng.choice(n_clusters, size=n_in, p=weights)
    pts = centers[which] + rng.normal(size=(n_in, d)) * scales[which, None]
    out = rng.uniform(-4.0, 5.0, size=(n_out, d))  # far, isolated outliers
    return np.concatenate([pts, out]).astype(np.float32)


def roadlike(n: int, seed: int = 0, n_roads: int = 200) -> np.ndarray:
    """3DRoad-like 2D: points sampled densely along random polylines."""
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


def shells(n: int, seed: int = 0, n_shells: int = 5) -> np.ndarray:
    """3DIono-like: concentric layered shells with varying density + noise."""
    rng = np.random.default_rng(seed)
    which = rng.integers(0, n_shells, size=n)
    radii = 0.2 + 0.15 * which + rng.normal(scale=0.01, size=n)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return (v * radii[:, None]).astype(np.float32)


def lidar_like(n: int, seed: int = 0) -> np.ndarray:
    """KITTI-like 3D: ground plane ring sweep + vertical structures + sparse far returns."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.7)
    n_wall = int(n * 0.25)
    n_far = n - n_ground - n_wall
    ang = rng.uniform(0, 2 * np.pi, n_ground)
    rr = np.abs(rng.gamma(2.0, 8.0, n_ground))  # radial density falls off
    ground = np.stack(
        [rr * np.cos(ang), rr * np.sin(ang), rng.normal(0, 0.05, n_ground)], 1
    )
    wx = rng.uniform(-30, 30, n_wall)
    wy = rng.choice([-8.0, 8.0], n_wall) + rng.normal(0, 0.2, n_wall)
    wz = rng.uniform(0, 4, n_wall)
    wall = np.stack([wx, wy, wz], 1)
    far = rng.uniform(-120, 120, size=(max(n_far, 0), 3))
    return np.concatenate([ground, wall, far]).astype(np.float32)[:n]


DATASETS = {
    "uniform": lambda n, seed=0: uniform(n, 3, seed),
    "porto": lambda n, seed=0: clustered(n, 2, seed),
    "road": lambda n, seed=0: roadlike(n, seed),
    "iono": lambda n, seed=0: shells(n, seed),
    "kitti": lambda n, seed=0: lidar_like(n, seed),
}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    return DATASETS[name](n, seed=seed)
