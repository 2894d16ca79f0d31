"""Training launcher of the port, on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 300 --batch 8 --seq 256 --preset small --ckpt /tmp/run1

Fault tolerance: resumes from the newest checkpoint in --ckpt
automatically; SIGTERM checkpoints before exit (preemption-safe).
``--mesh host`` trains on one device; ``--mesh prod`` / ``prod-multi``
shard the parameters, the moments and the batch over the 16x16 /
2x16x16 production mesh of the visible cards (``make_sharded_train_step``;
fewer cards raise the mesh's ``ValueError``).
"""

from __future__ import annotations

import argparse
import dataclasses
import signal

import torch

from .._device import resolve_device
from ..configs import get_config, smoke_config
from ..data import DataConfig, SyntheticLMStream
from ..models import init_params
from ..optim import adamw_init
from ..parallel import batch_shardings, param_shardings, shard_tree
from ..train import TrainConfig, Trainer, make_train_step
from ..train.trainer import make_sharded_train_step
from .mesh import make_production_mesh


def build(preset: str, arch: str):
    cfg = get_config(arch)
    if preset == "smoke":
        return smoke_config(cfg)
    if preset == "small":  # ~10-100M class, CPU-trainable
        return dataclasses.replace(
            smoke_config(cfg),
            d_model=256,
            n_heads=8,
            n_kv_heads=4,
            d_head=32,
            d_ff=1024 if cfg.d_ff else 0,
            vocab_size=8192,
            n_layers=min(cfg.n_layers, 8),
        )
    if preset == "full":
        return cfg
    raise ValueError(preset)


def main(argv=None):
    """Train, save the last step, and return the losses of the steps run
    (``Trainer.history``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--preset", default="small", choices=["smoke", "small", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", default="host", choices=["host", "prod", "prod-multi"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator the weights are drawn from")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh != "host":
        mesh = make_production_mesh(multi_pod=args.mesh == "prod-multi")

    dev = resolve_device(args.device)
    cfg = build(args.preset, args.arch)
    tcfg = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt,
    )
    model = init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = adamw_init(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M "
          f"device={dev}")

    stream = SyntheticLMStream(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
        )
    )
    if mesh is None:
        tr = Trainer(cfg, tcfg, model, opt, stream, make_train_step(cfg, tcfg))
    else:
        named = {k: v.detach() for k, v in model.named_parameters()}
        p_sh = param_shardings(named, cfg, mesh)
        o_sh = param_shardings(opt, cfg, mesh, role="opt")
        b_sh = batch_shardings(stream.batch_at(0), cfg, mesh)
        step = make_sharded_train_step(cfg, tcfg, mesh, p_sh, o_sh, b_sh)
        tr = Trainer(cfg, tcfg, shard_tree(named, p_sh), shard_tree(opt, o_sh),
                     stream, step, shardings={"params": p_sh, "opt": o_sh})
        del model, opt, named
    prev = tr.install_preemption_hook()
    try:
        if tr.maybe_restore():
            print(f"resumed from step {tr.step}")
        tr.run(args.steps - tr.step)
        tr.save()
    finally:
        signal.signal(signal.SIGTERM, prev)
    if tr.history:
        print(
            f"done: first-10 loss {sum(tr.history[:10])/min(10,len(tr.history)):.3f} "
            f"last-10 loss {sum(tr.history[-10:])/min(10,len(tr.history)):.3f}"
        )
    return tr.history


if __name__ == "__main__":
    main()
