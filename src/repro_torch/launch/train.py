"""Training launcher of the port, on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 300 --batch 8 --seq 256 --preset small --ckpt /tmp/run1

Fault tolerance: resumes from the newest checkpoint in --ckpt
automatically; SIGTERM checkpoints before exit (preemption-safe).  One
process on one device: ``--mesh host`` only.
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
from ..train import TrainConfig, Trainer, make_train_step


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
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains in one process on one "
            "device; sharded meshes are ROADMAP queue 1 item 16b")

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
    tr = Trainer(cfg, tcfg, model, opt, stream, make_train_step(cfg, tcfg))
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
