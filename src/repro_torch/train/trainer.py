"""Fault-tolerant training loop (port of ``repro.train.trainer``).

Failure posture:
  * checkpoint/restart — atomic publish and re-placed restore
    (checkpoint.py); the data stream is a pure function of the step, so
    restarts are exact;
  * NaN/inf guard — a step whose loss is not finite is *skipped*
    (parameters and the whole optimizer state untouched) and counted;
    persistent NaNs (>patience) raise instead of silently burning
    accelerator-hours;
  * preemption hook — SIGTERM triggers a final checkpoint before exit.

The model is an ``LM`` whose parameters the step updates in place; the
optimizer state is ``optim.adamw_init``'s dict.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models import loss_fn
from ..models.common import ModelConfig
from ..optim import adamw_update, cosine_schedule
from ..optim.adamw import global_norm

from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    checkpoint_every: int = 200
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    nan_patience: int = 10
    log_every: int = 10


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """(model, opt_state, step, batch) -> (model, opt_state, metrics).

    ``loss_fn``, its backward, the schedule's lr at ``step``, then AdamW
    on the model's parameters and the state in place; the gradients are
    cleared after.  The loss is read on the host once, before the
    update: when it is not finite the update is skipped (the reference's
    NaN guard), so the parameters and the optimizer state, ``count``
    included, are left as they were.  ``metrics["loss"]`` is that host
    value; the other metrics stay tensors."""

    def train_step(model, opt_state, step, batch):
        loss, metrics = loss_fn(model, cfg, batch)
        loss.backward()
        loss_value = float(loss.detach())
        lr = cosine_schedule(
            step,
            peak_lr=tcfg.peak_lr,
            warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps,
        )
        grads = {name: p.grad for name, p in model.named_parameters()}
        bad = not math.isfinite(loss_value)
        if bad:
            with torch.no_grad():
                opt_metrics = {"grad_norm": global_norm(grads)}
        else:
            model, opt_state, opt_metrics = adamw_update(
                model,
                grads,
                opt_state,
                lr,
                weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm,
            )
        model.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss_value
        metrics["lr"] = lr
        metrics["bad_step"] = int(bad)
        return model, opt_state, metrics

    return train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params, opt_state,
                 stream, train_step_fn):
        self.cfg, self.tcfg = cfg, tcfg
        self.params, self.opt_state = params, opt_state
        self.stream = stream
        self.train_step_fn = train_step_fn
        self.step = 0
        self.bad_streak = 0
        self.history = []
        self._preempted = False

    # --- fault tolerance hooks -------------------------------------------
    def install_preemption_hook(self):
        """SIGTERM sets a flag that makes ``run`` checkpoint and return.
        Returns the handler it replaced."""
        def handler(signum, frame):
            self._preempted = True

        return signal.signal(signal.SIGTERM, handler)

    def maybe_restore(self):
        d = self.tcfg.checkpoint_dir
        if not d:
            return False
        latest = ckpt.latest_step(d)
        if latest is None:
            return False
        state, _ = ckpt.restore_checkpoint(
            d, latest, {"params": self.params, "opt": self.opt_state}
        )
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = latest
        return True

    def save(self):
        if self.tcfg.checkpoint_dir:
            ckpt.save_checkpoint(
                self.tcfg.checkpoint_dir,
                self.step,
                {"params": self.params, "opt": self.opt_state},
                meta={"arch": self.cfg.name},
                keep_last=self.tcfg.keep_last,
            )

    # --- loop --------------------------------------------------------------
    def run(self, n_steps: int, log=print):
        t0 = time.perf_counter()
        device = self.params.device
        for _ in range(n_steps):
            batch = self.stream.batch_at(self.step)
            batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in batch.items()}
            self.params, self.opt_state, metrics = self.train_step_fn(
                self.params, self.opt_state, self.step, batch
            )
            bad = int(metrics["bad_step"])
            self.bad_streak = self.bad_streak + 1 if bad else 0
            if self.bad_streak > self.tcfg.nan_patience:
                raise RuntimeError(
                    f"{self.bad_streak} consecutive non-finite steps at {self.step}"
                )
            self.history.append(float(metrics["loss"]))
            if self.step % self.tcfg.log_every == 0:
                log(
                    f"step {self.step:6d} loss {float(metrics['loss']):8.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                    f"({(time.perf_counter()-t0):.1f}s)"
                )
            self.step += 1
            if (
                self.step % self.tcfg.checkpoint_every == 0
                or self._preempted
            ):
                self.save()
                if self._preempted:
                    log(f"preempted at step {self.step}; checkpoint saved")
                    return self.history
        return self.history
