"""Multi-pod dry-run (port of ``repro.launch.dryrun``): every (arch x shape
x mesh) cell on the 16x16 (single-pod) and 2x16x16 (multi-pod) production
meshes, with per-position memory, the step's FLOPs, the collectives and
the roofline, one JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both

The reference lowers and compiles each cell on 512 forced host devices.
The port has no compiler to ask, so an LM cell runs on the ``meta``
device (shapes and dtypes, no storage):

  * the parameters, moments, inputs and caches are built on meta and
    their shardings taken on a 256- or 512-position meta ``DeviceMesh``;
    a spec whose axes do not divide its dim fails the cell, and so do
    per-position argument bytes above one card's memory (the
    counterparts of a sharding mismatch and a compile-time OOM);
  * the global step runs once on meta under ``FlopCounterMode`` (train:
    ``loss_fn``, its backward and ``adamw_update``; prefill: ``prefill``;
    decode: ``decode_step``).  It counts products only (mm, bmm, addmm,
    sdpa, conv): ``"flops_counted": "products"``;
  * there is no fused program, so ``cost_bytes`` is None; the roofline's
    memory term takes the analytic ``model_memory_bytes`` instead;
  * collectives are ``analysis.step_collectives``' closed form for a
    train cell.  A prefill or decode cell records None, with
    ``collectives_note``: the port has no sharded serving step, so there
    is nothing to count, and the roofline leaves the term out.

The trueknn cell runs for real, on a mesh of 256 or 512 positions of one
device (the card by default): one query batch of the paper's technique,
through the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.trueknn import CONFIG
from ..core.distributed import DeviceMesh
from ..models import decode_step, loss_fn, prefill
from ..optim import adamw_update, cosine_schedule
from ..parallel.sharding import (
    _named_leaves,
    batch_shardings,
    cache_shardings,
    param_shardings,
)
from ..train import TrainConfig
from . import analysis
from .mesh import make_production_mesh
from .shapes import CELLS, cell_applicable, input_specs, opt_specs, params_specs

#: one H100's device memory (80 GB part), the per-position budget
DEVICE_BYTES = 80 * 2**30


def make_mesh(multi_pod: bool, device="meta") -> DeviceMesh:
    """The production mesh with every position on ``device``."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[device] * (512 if multi_pod else 256))


def _parse_variant(variant: str) -> dict:
    """"zero1,remat" -> {zero1: True, ...}; "n_heads=64" -> {n_heads: 64}."""
    out = {}
    for tok in variant.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = int(v)
        else:
            out[tok] = True
    return out


def lower_cell(arch: str, cell_name: str, multi_pod: bool, *,
               unroll: bool = False, variant: str = ""):
    """One cell's analysis record.

    ``unroll`` is accepted and changes no count: the reference unrolls
    because XLA's cost analysis counts a while body once, and the port's
    stacks are Python loops.  ``variant``: comma-separated ModelConfig
    overrides (e.g. "pure_dp", "zero1,remat")."""
    cfg = get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **_parse_variant(variant))
    cell = CELLS[cell_name]
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    rec = _lower_one(cfg, cell, multi_pod)
    mf = analysis.model_flops(cfg, cell)
    roof = rec["roofline"]
    return {
        "arch": arch,
        "cell": cell_name,
        "multi_pod": multi_pod,
        "status": "ok",
        **rec,
        "model_flops": mf,
        "useful_ratio": (
            mf / roof["hlo_flops_global"] if roof["hlo_flops_global"] else None
        ),
    }


def probe_cell(arch: str, cell_name: str, multi_pod: bool, variant: str = ""):
    """Depth-probe roofline: the arch at 1 and 2 pattern periods, the
    per-period marginal cost (embed/unembed/loss isolate in the diff),
    extrapolated to the real depth."""
    cfg0 = get_config(arch)
    cell = CELLS[cell_name]
    ok, reason = cell_applicable(cfg0, cell)
    if not ok:
        return {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    base = cfg0.first_k_dense
    period = cfg0.period

    def shallow(n_periods):
        cfg = dataclasses.replace(cfg0, n_layers=base + period * n_periods)
        if variant:
            cfg = dataclasses.replace(cfg, **_parse_variant(variant))
        return cfg

    r1, r2 = (_lower_one(shallow(n), cell, multi_pod) for n in (1, 2))
    n_periods_real = (cfg0.n_layers - base) / period
    out = {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
           "status": "ok", "method": "depth_probe",
           "n_chips": r1["n_chips"],
           "meta_step_s": r1["meta_step_s"] + r2["meta_step_s"],
           "flops_counted": "products"}
    if variant:
        out["variant"] = variant

    def extrap(a, b):
        if a is None or b is None:
            return None
        return a + (b - a) * (n_periods_real - 1)

    flops = extrap(r1["cost_flops"], r2["cost_flops"])
    out["cost_flops"] = flops
    out["cost_bytes"] = None
    c1, c2 = r1["collectives"], r2["collectives"]
    coll = None
    if c1 is None:
        out["collectives"] = None
        out["collectives_note"] = r1["collectives_note"]
    else:
        coll = int(extrap(c1["total_bytes"], c2["total_bytes"]))
        out["collectives"] = {"total_bytes": coll, "counts_1p": c1["counts"],
                              "counts_2p": c2["counts"]}
    mem = analysis.model_memory_bytes(cfg0, cell, r1["n_chips"])
    out["memory_lb_bytes"] = mem
    out["roofline"] = analysis.roofline(
        {"flops": flops, "bytes accessed": mem}, coll, r1["n_chips"]
    )
    mf = analysis.model_flops(cfg0, cell)
    out["model_flops"] = mf
    out["useful_ratio"] = (
        mf / out["roofline"]["hlo_flops_global"]
        if out["roofline"]["hlo_flops_global"] else None
    )
    return out


def _position_bytes(*trees) -> int:
    """Bytes one position holds of the tensors the shardings were made
    for; raises ``ValueError`` on a spec whose axes do not divide its
    dim."""
    total = 0
    for tree in trees:
        for _, sh in _named_leaves(tree):
            total += int(np.prod(sh.local_shape(sh.shape))) * sh.dtype.itemsize
    return total


def _lower_one(cfg, cell, multi_pod: bool):
    """Shardings, per-position bytes, the meta step's FLOPs and the
    collectives of one concrete config."""
    mesh = make_mesh(multi_pod)
    n_chips = int(mesh.devices.size)
    t0 = time.perf_counter()
    params = params_specs(cfg)
    p_sh = param_shardings(params, cfg, mesh)
    spec = input_specs(cfg, cell)
    caches = spec.pop("caches", None)
    spec.pop("pos", None)  # a replicated scalar; decode takes an int
    b_sh = batch_shardings(spec, cfg, mesh)
    o_sh = c_sh = None
    args = [p_sh, b_sh]
    if cell.kind == "train":
        opt = opt_specs(params)
        o_sh = param_shardings(opt, cfg, mesh, role="opt")
        args.append(o_sh)
    else:
        c_sh = cache_shardings(caches, cfg, mesh)
        args.append(c_sh)
    arg_bytes = _position_bytes(*args)
    if arg_bytes > DEVICE_BYTES:
        raise MemoryError(
            f"{arg_bytes / 2**30:.2f} GiB of arguments per position exceed "
            f"one card's {DEVICE_BYTES / 2**30:.0f} GiB")
    t_lower = time.perf_counter() - t0

    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        if cell.kind == "train":
            tcfg = TrainConfig()
            loss, _ = loss_fn(params, cfg, spec)
            loss.backward()
            lr = cosine_schedule(0, peak_lr=tcfg.peak_lr,
                                 warmup_steps=tcfg.warmup_steps,
                                 total_steps=tcfg.total_steps)
            grads = {n: p.grad for n, p in params.named_parameters()}
            adamw_update(params, grads, opt, lr,
                         weight_decay=tcfg.weight_decay,
                         max_grad_norm=tcfg.max_grad_norm)
        else:
            with torch.no_grad():
                if cell.kind == "prefill":
                    prefill(params, cfg, spec["tokens"], caches,
                            prefix_embeds=spec.get("prefix_embeds"))
                else:
                    decode_step(params, cfg, spec["token"], cell.seq_len - 1,
                                caches)
    t_step = time.perf_counter() - t0
    flops = counter.get_total_flops() / n_chips
    log = analysis.step_collectives(p_sh, o_sh, b_sh, cell.kind)
    coll = None if log is None else analysis.collective_bytes(log)
    mem = analysis.model_memory_bytes(cfg, cell, n_chips)
    note = {} if log is not None else {
        "collectives_note": "no sharded serving step in the port"}
    return {
        "n_chips": n_chips,
        "lower_s": round(t_lower, 2),
        "meta_step_s": round(t_step, 2),
        "memory": {"argument_size_in_bytes": arg_bytes},
        "cost_flops": flops,
        "cost_bytes": None,
        "flops_counted": "products",
        "memory_lb_bytes": mem,
        "collectives": coll,
        **note,
        "roofline": analysis.roofline(
            {"flops": flops, "bytes accessed": mem},
            None if coll is None else coll["total_bytes"], n_chips),
    }


def lower_trueknn_cell(multi_pod: bool, engine: str = "dense", *,
                       device="cuda", kcfg=CONFIG, seed: int = 0):
    """The paper's technique as a dry-run cell, executed: one query batch
    over ``kcfg.n_points`` uniform points per model shard, on a mesh of
    256 or 512 positions of ``device``.

    engine="dense": ``make_distributed_knn``, one ``pairwise_topk`` launch
    per position, then the hypercube merge (exact kNN).
    engine="grid": one fixed-radius round (``make_grid_round``, one
    ``grid_round`` launch per position) over per-shard hash grids
    (``build_stacked_grids``) at the radius whose ball holds k points on
    average: each row's in-radius top-k and ``found``.

    Returns (record, points, queries, (d2, idx, counts)), the answers on
    the mesh's first device."""
    from ..core.distributed import make_distributed_knn
    from ..core.distributed_grid import (build_stacked_grids,
                                         make_grid_round, shard_points)
    from ..kernels import build

    mesh = make_mesh(multi_pod, device)
    dev = mesh.first_device
    n_chips = int(mesh.devices.size)
    p_size = mesh.shape["model"]
    rng = np.random.default_rng(seed)
    n_total = kcfg.n_points * p_size
    pts = rng.random((n_total, kcfg.dim), dtype=np.float32)
    qs = rng.random((kcfg.n_queries, kcfg.dim), dtype=np.float32)
    qid = np.full((kcfg.n_queries,), -1, np.int32)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rec = {"arch": "trueknn", "engine": engine,
           "cell": f"knn_{engine}_{kcfg.n_points}x{p_size}pts_"
                   f"{kcfg.n_queries}q",
           "multi_pod": multi_pod, "status": "ok", "n_chips": n_chips,
           "device": str(dev)}
    t0 = time.perf_counter()
    if engine == "dense":
        fn = make_distributed_knn(mesh, kcfg.k)
        points = pts

        def run():
            return fn(points, qs, qid)
    else:
        shards, n_valid = shard_points(pts, p_size)
        # the radius whose ball holds k of the uniform cloud's points on
        # average: about half the rows resolve in this round
        radius = float((kcfg.k / (n_total * _ball_volume(kcfg.dim)))
                       ** (1.0 / kcfg.dim))
        grids, table, cap = build_stacked_grids(shards, n_valid, radius,
                                                device=dev)
        # one sentinel row per shard, as the round's contract asks
        stacked = np.concatenate(
            [shards, np.full((p_size, 1, kcfg.dim), np.inf, np.float32)], 1)
        fn = make_grid_round(mesh, kcfg.k, table)
        r2 = float(np.float32(radius) ** 2)
        rec.update(radius=radius, table=table, cap=cap)

        def run():
            return fn(stacked, grids, qs, qid, r2)[:3]
    rec["setup_s"] = time.perf_counter() - t0
    walls = []
    for _ in range(2):  # first call, then warm
        before = build.launch_counts()
        t0 = time.perf_counter()
        out = run()
        sync()
        walls.append(time.perf_counter() - t0)
        launches = {k: v - before[k] for k, v in build.launch_counts().items()}
    rec.update(first_s=walls[0], warm_s=walls[1], launches=launches)
    return rec, pts, qs, out


def _ball_volume(d: int) -> float:
    return math.pi ** (d / 2) / math.gamma(d / 2 + 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument(
        "--unroll", action="store_true",
        help="accepted for the reference's command lines; the port's "
             "counts are those of the unrolled stack already",
    )
    ap.add_argument(
        "--variant", default="",
        help="comma-separated ModelConfig bool overrides (pure_dp, remat)",
    )
    ap.add_argument(
        "--probe", action="store_true",
        help="depth-probe roofline (1 vs 2 periods, extrapolated)",
    )
    ap.add_argument(
        "--knn-engine", default="dense", choices=["dense", "grid"],
        help="trueknn cell engine (grid = per-shard hash grids)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the trueknn cell runs (cuda, the default, or cpu); "
             "the LM cells run on meta",
    )
    args = ap.parse_args(argv)

    archs = list(ARCHS) + ["trueknn"] if args.arch == "all" else [args.arch]
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    records = []
    for arch in archs:
        for multi_pod in meshes:
            for cell in (["-"] if arch == "trueknn" else cells):
                tag = f"{arch}__{cell}__{'multi' if multi_pod else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[dry-run] {tag} ...", flush=True)
                try:
                    if arch == "trueknn":
                        if (torch.device(args.device).type == "cuda"
                                and not torch.cuda.is_available()):
                            rec = {"arch": arch, "cell": cell,
                                   "multi_pod": multi_pod,
                                   "status": "skipped",
                                   "reason": "the trueknn cell runs its "
                                   "kernels on the card and "
                                   "torch.cuda.is_available() is False"}
                        else:
                            rec = lower_trueknn_cell(
                                multi_pod, engine=args.knn_engine,
                                device=args.device)[0]
                    elif args.probe:
                        rec = probe_cell(arch, cell, multi_pod, args.variant)
                    else:
                        rec = lower_cell(arch, cell, multi_pod,
                                         unroll=args.unroll,
                                         variant=args.variant)
                        if args.variant:
                            rec["variant"] = args.variant
                except Exception as e:  # a failed cell is a record, not a stop
                    rec = {
                        "arch": arch, "cell": cell, "multi_pod": multi_pod,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                status = rec["status"]
                if status == "ok" and "roofline" in rec:
                    extra = (f" meta_step={rec.get('meta_step_s')}s "
                             f"dominant={rec['roofline']['dominant']}")
                elif status == "ok":
                    extra = (f" first={rec['first_s']:.3f}s "
                             f"warm={rec['warm_s']:.3f}s "
                             f"launches={rec['launches']}")
                else:
                    extra = " " + rec.get("reason", rec.get("error", ""))[:200]
                print(f"  -> {status}{extra}", flush=True)
    return records


if __name__ == "__main__":
    main()
