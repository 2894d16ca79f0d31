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

from torch import nn

from ..models import loss_fn
from ..models.common import ModelConfig
from ..models.model import LM
from ..optim import adamw_update, cosine_schedule
from ..optim.adamw import global_norm
from ..parallel.sharding import _axes, _map_tree, gather_tree

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


def _finish_step(tcfg: TrainConfig, step, loss, metrics: dict, grads: dict,
                 update: Callable) -> dict:
    """The tail both steps share: the loss read on the host once, the
    schedule's lr at ``step``, the gradients' global norm, then
    ``update(lr, grad_norm)`` unless the loss is not finite (the
    reference's NaN guard: the parameters and the optimizer state,
    ``count`` included, are left as they were).  Returns ``metrics``
    detached, with ``loss`` (the host value), ``lr``, ``grad_norm`` and
    ``bad_step``."""
    loss_value = float(loss.detach())
    lr = cosine_schedule(
        step,
        peak_lr=tcfg.peak_lr,
        warmup_steps=tcfg.warmup_steps,
        total_steps=tcfg.total_steps,
    )
    with torch.no_grad():
        gnorm = global_norm(grads)
    bad = not math.isfinite(loss_value)
    if not bad:
        update(lr, gnorm)
    out = {k: v.detach() for k, v in metrics.items()}
    out.update(loss=loss_value, lr=lr, grad_norm=gnorm, bad_step=int(bad))
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """(model, opt_state, step, batch) -> (model, opt_state, metrics).

    ``loss_fn``, its backward, then ``_finish_step``: AdamW on the
    model's parameters and the state in place at the schedule's lr,
    skipped when the loss is not finite; the gradients are cleared
    after.  ``metrics["loss"]`` is the host value; the other metrics stay
    tensors."""

    def train_step(model, opt_state, step, batch):
        loss, metrics = loss_fn(model, cfg, batch)
        loss.backward()
        grads = {name: p.grad for name, p in model.named_parameters()}

        def update(lr, gnorm):
            adamw_update(model, grads, opt_state, lr,
                         weight_decay=tcfg.weight_decay,
                         max_grad_norm=tcfg.max_grad_norm, grad_norm=gnorm)

        metrics = _finish_step(tcfg, step, loss, metrics, grads, update)
        model.zero_grad(set_to_none=True)
        return model, opt_state, metrics

    return train_step


def _bind(model: nn.Module, named: dict) -> nn.Module:
    """``model`` with each parameter replaced by a fresh leaf over
    ``named``'s tensor of the same name (shared storage, its own grad)."""
    for name, t in named.items():
        mod_path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        mod.register_parameter(leaf, nn.Parameter(t, requires_grad=True))
    return model


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                            p_sh: dict, o_sh: dict, b_sh: dict) -> Callable:
    """(params, opt_state, step, batch) -> (params, opt_state, metrics) on
    ``mesh`` (a ``DeviceMesh``): the counterpart of ``jax.jit(step,
    in_shardings=(p_sh, o_sh, replicated, b_sh), out_shardings=(p_sh,
    o_sh, None))``.

    ``params`` and ``opt_state`` are per-position slices
    (``parallel.shard_tree`` of the parameters' dict and of AdamW's state
    by ``p_sh`` and ``o_sh``), updated in place and returned; ``batch`` is
    the whole batch, split into data rows by ``b_sh``.

    Each data row (the positions holding one slice of the batch) gathers
    the whole weights and runs ``loss_fn`` and its backward on its slice,
    on the device of its first position; each row's loss is weighted by
    its share of the batch's loss tokens, so the loss and the gradients
    are the global batch's.  An MoE config computes the whole batch in
    one group instead: its expert capacity follows the batch's token
    count and its Switch aux loss is a product of batch means, so rows
    computed apart would drop other tokens and weigh another aux loss.
    The gradients are summed over the rows in float32, clipped by their
    global norm, and split to the moments' slices; ``adamw_update`` then
    runs on every position's slices.  Under ZeRO-1 (the parameters' spec
    lacks the moments' FSDP axes) each position updates its moments' part
    of its parameter slice and the parts are gathered back.
    Tensor-parallel compute is not partitioned: the model axis only holds
    slices (ROADMAP B13).  The loss is read on the host once, and a step
    whose loss is not finite updates nothing.

    ``metrics["collectives"]`` is the step's collective log, appended
    where tensors move between positions, one entry per collective with
    one position's result bytes: each weight put together from its
    slices, each gradient split to the moments' slices when the batch
    spans several rows, each ZeRO-1 parameter slice filled from its
    peers (``launch.analysis.step_collectives`` is its closed form)."""
    positions = list(np.ndindex(mesh.devices.shape))
    tok_sh = next(iter(b_sh.values()))
    b_dims = [mesh.axis_names.index(a) for e in tok_sh.spec[:1]
              for a in _axes(e)]
    rows: dict = {}  # the batch's slice -> the positions holding it
    cols: dict = {}  # the other coordinates -> the positions sharing them
    for pos in positions:
        rows.setdefault(tuple(pos[i] for i in b_dims), []).append(pos)
        cols.setdefault(tuple(c for i, c in enumerate(pos)
                              if i not in b_dims), []).append(pos)
    rows, cols = list(rows.values()), list(cols.values())
    groups = [positions] if cfg.n_experts else rows
    mu_sh = o_sh["mu"]

    def take(v, sh, group):
        v = torch.as_tensor(v)
        return v if len(group) == len(positions) else v[
            sh.index(group[0], v.shape)]

    def train_step(params, opt_state, step, batch):
        log = []
        names = list(p_sh)
        full = {name: p_sh[name].gather(
            {pos: params[pos][name] for pos in positions}, log=log)
            for name in names}
        first = mesh.first_device
        devs = [mesh.devices[g[0]] for g in groups]
        batches = [{k: take(v, b_sh[k], g).to(dev) for k, v in batch.items()}
                   for g, dev in zip(groups, devs)]
        counts = [(b["labels"] >= 0).sum().to(first, torch.float32)
                  for b in batches]
        total = torch.clamp(torch.stack(counts).sum(), min=1.0)
        loss = torch.zeros((), dtype=torch.float32, device=first)
        stats = {"nll": loss, "aux": loss}
        gsum = {}
        for dev, b, n in zip(devs, batches, counts):
            model = _bind(LM(cfg, "meta"), {k: v.to(dev)
                                             for k, v in full.items()})
            w = (n / total).to(dev)
            loss_r, m_r = loss_fn(model, cfg, b)
            (loss_r * w).backward()
            loss = loss + (loss_r.detach() * w).to(first)
            stats = {k: stats[k] + (m_r[k].detach() * w).to(first)
                     for k in stats}
            for name, p in model.named_parameters():
                g = p.grad.to(first, torch.float32)
                gsum[name] = g if name not in gsum else gsum[name] + g
            del model
        grads = {name: gsum[name].to(full[name].dtype) for name in names}
        del gsum

        def update(lr, gnorm):
            for pos in positions:
                dev = mesh.devices[pos]
                own, g_own = {}, {}
                for name in names:
                    shape = full[name].shape
                    o_idx = mu_sh[name].index(pos, shape)
                    own[name] = params[pos][name][_within(
                        o_idx, p_sh[name].index(pos, shape))]
                    g_own[name] = grads[name][o_idx].to(dev)
                    if pos == positions[0] and len(rows) > 1:
                        log.append(_split_entry(mu_sh[name], shape, cols,
                                                g_own[name]))
                adamw_update(own, g_own, opt_state[pos], lr,
                             weight_decay=tcfg.weight_decay,
                             max_grad_norm=tcfg.max_grad_norm,
                             grad_norm=gnorm.to(dev))
            _zero1_gather(params, names, full, p_sh, mu_sh, positions, log)

        metrics = _finish_step(tcfg, step, loss, stats, grads, update)
        metrics.update(tokens=total, collectives=log)
        return params, opt_state, metrics

    return train_step


def _split_entry(sh, shape, cols, part) -> tuple:
    """The log entry of a gradient reduced over the data rows and split
    to the slices of ``sh``: a reduce-scatter when positions that differ
    only in their batch coordinates (one of ``cols``) take different
    slices, else an all-reduce; ``part`` is one position's slice."""
    scattered = any(
        len({sh.index(pos, shape) for pos in col}) > 1 for col in cols)
    return ("reduce-scatter" if scattered else "all-reduce",
            part.numel() * part.element_size())


def _within(inner: tuple, outer: tuple) -> tuple:
    """Slices ``inner`` of a tensor as slices of its part ``outer``."""
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for i, o in zip(inner, outer))


def _zero1_gather(params, names, full, p_sh, mu_sh, positions, log):
    """Where a parameter's slice spans several moment slices (ZeRO-1),
    every position copies its peers' updated parts into its own slice;
    ``log`` gains one all-gather of the slice's bytes for each such
    parameter."""
    for name in names:
        shape = full[name].shape
        copied = False
        for pos in positions:
            p_idx = p_sh[name].index(pos, shape)
            for peer in positions:
                if peer == pos or p_sh[name].index(peer, shape) != p_idx:
                    continue
                rel = _within(mu_sh[name].index(peer, shape), p_idx)
                if rel == _within(mu_sh[name].index(pos, shape), p_idx):
                    continue  # the same moment slice: updated alike
                params[pos][name][rel] = params[peer][name][rel].to(
                    params[pos][name].device)
                copied = True
        if copied:
            part = params[positions[0]][name]
            log.append(("all-gather", part.numel() * part.element_size()))


class Trainer:
    """The training loop over ``train_step_fn``.  ``params`` is an ``LM``
    and ``opt_state`` AdamW's state; or, with ``shardings`` (``{"params":
    p_sh, "opt": o_sh}``), both are per-position slices for
    ``make_sharded_train_step``, checkpointed whole and restored onto the
    current mesh."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params, opt_state,
                 stream, train_step_fn, *, shardings=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.params, self.opt_state = params, opt_state
        self.shardings = shardings
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
        if self.shardings:
            like = {k: _map_tree(sh, lambda _, s: torch.empty(
                s.shape, dtype=s.dtype, device="meta"))
                for k, sh in self.shardings.items()}
        else:
            like = {"params": self.params, "opt": self.opt_state}
        state, _ = ckpt.restore_checkpoint(d, latest, like,
                                           shardings=self.shardings)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = latest
        return True

    def save(self):
        if self.tcfg.checkpoint_dir:
            state = {"params": self.params, "opt": self.opt_state}
            if self.shardings:
                state = {k: gather_tree(v, self.shardings[k])
                         for k, v in state.items()}
            ckpt.save_checkpoint(
                self.tcfg.checkpoint_dir,
                self.step,
                state,
                meta={"arch": self.cfg.name},
                keep_last=self.tcfg.keep_last,
            )

    # --- loop --------------------------------------------------------------
    def run(self, n_steps: int, log=print):
        t0 = time.perf_counter()
        # a sharded step moves each data row's slice of the batch itself
        device = None if self.shardings else self.params.device
        for _ in range(n_steps):
            batch = self.stream.batch_at(self.step)
            batch = {k: torch.as_tensor(np.asarray(v), device=device)
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
