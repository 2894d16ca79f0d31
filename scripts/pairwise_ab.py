#!/usr/bin/env python3
"""The ``pairwise_topk`` kernels of two checkouts, timed in turns on one
card.

    python3 scripts/pairwise_ab.py --other PATH

Builds this checkout's CUDA extension (``repro_torch.kernels.build``) and
the sources under ``PATH/src/repro_torch/csrc`` (another checkout, such as
the parent commit unpacked with ``git archive``) as a second extension.
At each shape it runs the first pass and the merge of both, each with its
own split (``choose_splits`` over the rows a block that each extension
reports), checks that the two give the same outputs bitwise, and times
both passes of each in the order other, this, this, other with CUDA
events (``ab_common.median_ms``).  The points are kitti 2^20;
shapes: the main path's Q = 4096 call at k = 32 (phase 4's radius), the
Alg. 2 sampler's Q = 100 at k = 5, an L1 call of 4096 rows on 2^17
points at k = 128 (the placed range escalation's shape), single-row and
eight-row calls at k = 256, 4096-row self-queries at k = 64, 128, 256
and 1024, 512 rows at k = 300, and the L1 call at k = 1100, above the
register lists.  Prints the card's name and power limit, then one JSON
line a shape.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
from ab_common import N, RADIUS, card_line, median_ms, other_extension


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pairwise_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.pairwise_topk import METRIC_IDS, choose_splits

    print(card_line(), flush=True)
    exts = {"this": build.extension(), "other": other_extension(args.other)}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pts = torch.as_tensor(make_dataset("kitti", N), device=dev)
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(rng.choice(N, 4096, replace=False), device=dev)
    q = pts[rows].contiguous()
    self_ids = rows.to(torch.int32)
    none = torch.full((4096,), N, dtype=torch.int32, device=dev)
    thr = float(np.float32(RADIUS) ** 2)
    block = pts[: 1 << 17].contiguous()
    no_self = torch.full((4096,), -1, dtype=torch.int32, device=dev)
    shapes = [
        ("Q=4096 N=2^20 k=32 range", q, none, pts, 32, thr, "l2"),
        ("Q=100 N=2^20 k=5 sampler", q[:100].contiguous(), none[:100], pts,
         5, math.inf, "l2"),
        ("Q=4096 N=2^17 k=128 l1 (kitti[:2^17])", q, no_self, block, 128,
         2 * RADIUS, "l1"),
        ("Q=1 N=2^20 k=256", q[:1].contiguous(), none[:1], pts, 256, thr,
         "l2"),
        ("Q=8 N=2^20 k=256", q[:8].contiguous(), none[:8], pts, 256, thr,
         "l2"),
        ("Q=4096 N=2^20 k=64 self-query", q, self_ids, pts, 64, thr, "l2"),
        ("Q=4096 N=2^20 k=128 self-query", q, self_ids, pts, 128, thr, "l2"),
        ("Q=4096 N=2^20 k=256 self-query", q, self_ids, pts, 256, thr, "l2"),
        ("Q=4096 N=2^20 k=1024 self-query", q, self_ids, pts, 1024, thr,
         "l2"),
        ("Q=512 N=2^20 k=300", q[:512].contiguous(), none[:512], pts, 300,
         thr, "l2"),
        ("Q=4096 N=2^17 k=1100 l1 (kitti[:2^17])", q, no_self, block, 1100,
         2 * RADIUS, "l1"),
    ]
    for tag, qq, qi, p, k, t, metric in shapes:
        nq, n, d = qq.shape[0], p.shape[0], p.shape[1]
        runs = {}
        for name, ext in exts.items():
            per_block = ext.pairwise_topk_rows_per_block(d, k,
                                                         METRIC_IDS[metric])
            s, span = choose_splits(nq, n, k, sms, per_block)
            part = (torch.empty((s, nq, k), device=dev),
                    torch.empty((s, nq, k), dtype=torch.int32, device=dev),
                    torch.empty((s, nq), dtype=torch.int32, device=dev))
            out = (torch.empty((nq, k), device=dev),
                   torch.empty((nq, k), dtype=torch.int32, device=dev),
                   torch.empty((nq,), dtype=torch.int32, device=dev))

            def first(ext=ext, s=s, span=span, part=part):
                ext.pairwise_topk(qq, qi, p, None, k, s, span, t,
                                  METRIC_IDS[metric], *part)

            def merge(ext=ext, part=part, out=out):
                ext.pairwise_topk_merge(*part, None, n, *out)

            first()
            if s > 1:
                merge()
            runs[name] = {"S": s, "first": first,
                          "merge": merge if s > 1 else None,
                          "out": out if s > 1 else part}
        torch.cuda.synchronize()
        a, b = runs["this"]["out"], runs["other"]["out"]
        same = all(torch.equal(x.reshape(y.shape), y) for x, y in zip(a, b))
        times = {name: {"first_ms": [], "merge_ms": []} for name in runs}
        for name in ("other", "this", "this", "other"):
            r = runs[name]
            times[name]["first_ms"].append(
                median_ms(lambda _: r["first"]())[0])
            times[name]["merge_ms"].append(
                median_ms(lambda _: r["merge"]())[0] if r["merge"] else 0.0)
        print(json.dumps({
            "shape": tag, "bitwise_equal": same,
            **{name: {"S": runs[name]["S"], **times[name]}
               for name in ("other", "this")},
        }), flush=True)
        if not same:
            print(f"pairwise_ab: {tag}: outputs differ", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
