#!/usr/bin/env python3
"""Host syncs, launches and wall time of the placed shard fabric's
queries, for one checkout of the port.

    python3 scripts/placed_syncs.py [--src PATH] [--tag NAME]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
builds ``chip_smoke.py`` phase 15's index (kitti 2^20, 8 morton shards of
trueknn, ``placement="devices"`` on the card) and runs its queries: two
fused ``KnnSpec(8)`` batches of 2^16 rows, then on 4096 rows the
per-round cosine ``KnnSpec(8)``, ``HybridSpec(8, r)``, ``RangeSpec(r)``
and the escalating L1 ``RangeSpec(2r)`` (r = 0.122349, phase 4's median
8th-neighbor distance).  Per query it prints one JSON line: the fabric's
dispatches and host syncs, the ``pairwise_topk`` launches, the host wall
time to a device sync, and a digest of the answer (equal digests: equal
answers, bitwise).  Run it on two checkouts in one call to compare them
on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

RADIUS = 0.122349  # chip_smoke.py phase 4: median 8th-NN distance
N = 1 << 20
ROWS = 4096
BATCH = 1 << 16


def digest(res) -> str:
    h = hashlib.sha256()
    for key in ("offsets", "idxs", "dists", "found"):
        v = getattr(res, key, None)
        if v is not None:
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("placed_syncs: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import (HybridSpec, KnnSpec, RangeSpec, build_index,
                             make_dataset)
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.extension()
    pts = make_dataset("kitti", N)
    rng = np.random.default_rng(0)
    index = build_index(pts, backend="sharded", n_shards=8,
                        child_backend="trueknn", placement="devices")
    q5 = pts[np.sort(rng.choice(N, ROWS, replace=False))]
    runs = [(f"KnnSpec(8) batch {b}", pts[np.sort(rng.choice(
        N, BATCH, replace=False))], KnnSpec(8), "l2") for b in (1, 2)]
    runs += [("cosine KnnSpec(8)", q5, KnnSpec(8), "cosine"),
             ("HybridSpec(8, r)", q5, HybridSpec(8, RADIUS), "l2"),
             ("RangeSpec(r)", q5, RangeSpec(RADIUS), "l2"),
             ("L1 RangeSpec(2r)", q5, RangeSpec(2 * RADIUS), "l1")]
    for name, q, spec, metric in runs:
        fab = index._placed
        d0, s0 = (fab.dispatches, fab.syncs) if fab else (0, 0)
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.query(q, spec, metric=metric)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fab = index._placed
        print(json.dumps({
            "tag": args.tag, "query": name, "wall_s": wall,
            "dispatches": fab.dispatches - d0, "syncs": fab.syncs - s0,
            "launches": build.launch_counts()["pairwise_topk"],
            "digest": digest(res), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
