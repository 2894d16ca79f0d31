"""The port stands alone: ``repro_torch`` imports neither JAX nor any module
of the reference package ``repro``, and neither does ``chip_smoke.py``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
import repro_torch
from repro_torch import KnnSpec, RangeSpec, build_index, make_dataset

pts = make_dataset("kitti", 400, seed=0)
res = build_index(pts, backend="trueknn", device="cpu").query(None, KnnSpec(4))
assert res.dists.shape == (400, 4) and np.isfinite(res.dists).all()
rng = build_index(pts, backend="brute", device="cpu").query(
    pts[:10], RangeSpec(1.0))
assert rng.n_queries == 10
import repro_torch.api.backends.fixed_radius
import repro_torch.workloads
from repro_torch.workloads import build_knn_graph, dbscan

fr = build_index(pts, backend="fixed_radius", radius=0.5, device="cpu")
assert build_knn_graph(fr, 3).n == 400
assert dbscan(fr, 0.5, 4).labels.shape == (400,)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
print("OK")
"""


def test_imports_and_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b(?!_torch))", re.M
)


def test_no_jax_or_reference_import_lines():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (str(f), hits)
