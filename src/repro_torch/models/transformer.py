"""Decoder assembly: residual blocks over a per-layer kind pattern;
train/prefill/decode paths (port of ``repro.models.transformer``).

The reference stacks the body's parameters by period and runs them under
one ``lax.scan``; the port keeps one ``Layer`` per layer in a flat list
and runs the stacks as Python loops in layer order, which is the order
the reference's prefix, scanned periods and suffix visit them
(``stack_plan``).  ``scan_layers`` changes nothing here; ``remat``
checkpoints each scanned period in the backward, as the reference does.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import mla, moe, rglru, ssm
from .common import MLP, ModelConfig, new_param, rms_norm

# ------------------------------------------------------------- layer init


def _layer_uses_moe(cfg: ModelConfig, idx: int) -> bool:
    return cfg.n_experts > 0 and idx >= cfg.first_k_dense


def _kind_has_mlp(kind: str) -> bool:
    return kind != "ssm"  # mamba2 blocks are mixing-only


def _resolve_kind(cfg: ModelConfig, kind: str) -> str:
    """'attn' resolves to the config's attention type."""
    if kind == "attn" and cfg.attn_type == "mla":
        return "mla"
    return kind


_MIXERS = {"attn": attn.Attention, "local": attn.Attention, "mla": mla.MLA,
           "ssm": ssm.SSM, "rglru": rglru.RGLRU}


class Layer(nn.Module):
    """One residual block: ``norm1`` + ``mix`` (the layer kind's mixer),
    then ``norm2`` + ``mlp`` (dense SwiGLU or MoE) unless the kind is
    mixing-only."""

    def __init__(self, cfg: ModelConfig, idx: int, device):
        super().__init__()
        kind = _resolve_kind(cfg, cfg.layer_kinds[idx])
        if kind not in _MIXERS:
            raise ValueError(f"unknown layer kind {kind!r}")
        dt = cfg.pdtype()
        self.norm1 = new_param((cfg.d_model,), dt, device)
        self.mix = _MIXERS[kind](cfg, device)
        if _kind_has_mlp(kind):
            self.norm2 = new_param((cfg.d_model,), dt, device)
            self.mlp = (moe.MoE(cfg, device) if _layer_uses_moe(cfg, idx)
                        else MLP(cfg.d_model, cfg.d_ff, dt, device))

    @torch.no_grad()
    def init(self, gen):
        self.norm1.zero_()
        self.mix.init(gen)
        if hasattr(self, "mlp"):
            self.norm2.zero_()
            self.mlp.init(gen)


# --------------------------------------------------------- forward blocks


def _mlp(p, x, cfg: ModelConfig):
    """The block's second half: (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not hasattr(p, "mlp"):
        return x, aux
    h = rms_norm(x, p.norm2, upcast=not cfg.bf16_norm)
    if isinstance(p.mlp, moe.MoE):
        out, aux = moe.moe_apply(p.mlp, h, cfg)
    else:
        out = p.mlp(h)
    return x + out, aux


def apply_layer(p, x, cos, sin, cfg: ModelConfig, kind: str):
    """Training/prefill-style full-sequence block.  Returns (x, aux)."""
    kind = _resolve_kind(cfg, kind)
    h = rms_norm(x, p.norm1, upcast=not cfg.bf16_norm)
    if kind == "attn":
        mix = attn.attn_apply(p.mix, h, cos, sin, cfg)
    elif kind == "local":
        mix = attn.attn_apply(p.mix, h, cos, sin, cfg,
                              window=cfg.local_window)
    elif kind == "mla":
        mix = mla.mla_apply(p.mix, h, cos, sin, cfg)
    elif kind == "ssm":
        mix = ssm.ssm_apply(p.mix, h, cfg)
    else:
        mix = rglru.rglru_apply(p.mix, h, cfg)
    return _mlp(p, x + mix, cfg)


def decode_layer(p, x, cos, sin, cfg: ModelConfig, kind: str, cache,
                 pos: int):
    kind = _resolve_kind(cfg, kind)
    h = rms_norm(x, p.norm1, upcast=not cfg.bf16_norm)
    if kind == "attn":
        mix, cache = attn.attn_decode(p.mix, h, cos, sin, cfg, cache, pos)
    elif kind == "local":
        mix, cache = attn.attn_decode(p.mix, h, cos, sin, cfg, cache, pos,
                                      window=cfg.local_window)
    elif kind == "mla":
        mix, cache = mla.mla_decode(p.mix, h, cos, sin, cfg, cache, pos)
    elif kind == "ssm":
        mix, cache = ssm.ssm_decode(p.mix, h, cfg, cache)
    else:
        mix, cache = rglru.rglru_decode(p.mix, h, cfg, cache)
    return _mlp(p, x + mix, cfg)[0], cache


def prefill_layer(p, x, cos, sin, cfg: ModelConfig, kind: str, cache):
    kind = _resolve_kind(cfg, kind)
    h = rms_norm(x, p.norm1, upcast=not cfg.bf16_norm)
    if kind == "attn":
        mix, cache = attn.attn_prefill(p.mix, h, cos, sin, cfg, cache)
    elif kind == "local":
        mix, cache = attn.attn_prefill(p.mix, h, cos, sin, cfg, cache,
                                       window=cfg.local_window)
    elif kind == "mla":
        mix, cache = mla.mla_prefill(p.mix, h, cos, sin, cfg, cache)
    elif kind == "ssm":
        mix, cache = ssm.ssm_prefill(p.mix, h, cfg, cache)
    else:
        mix, cache = rglru.rglru_prefill(p.mix, h, cfg, cache)
    return _mlp(p, x + mix, cfg)[0], cache


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     dtype, device):
    kind = _resolve_kind(cfg, kind)
    if kind in ("attn", "local"):
        # sliding-window layers only ever need window slots
        s = min(seq, cfg.local_window) if kind == "local" else seq
        return attn.init_kv_cache(cfg, batch, max(s, 1), dtype, device)
    if kind == "mla":
        return mla.init_mla_cache(cfg, batch, seq, dtype, device)
    if kind == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


# ------------------------------------------------------ stack organization


def stack_plan(cfg: ModelConfig):
    """(prefix_ids, scan_periods, suffix_ids); body grouped by period: the
    reference's layout of stacked parameters."""
    n = cfg.n_layers
    pre = list(range(cfg.first_k_dense))
    period = cfg.period
    body_start = len(pre)
    n_periods = (n - body_start) // period
    scanned = [
        [body_start + i * period + j for i in range(n_periods)]
        for j in range(period)
    ]
    suffix = list(range(body_start + n_periods * period, n))
    return pre, scanned, suffix


def apply_stack(layers, x, cos, sin, cfg: ModelConfig):
    """Full-sequence forward through all layers.  Returns (x, aux_sum).

    With ``cfg.remat`` and autograd recording, each period of the scanned
    body runs under ``torch.utils.checkpoint``, as the reference wraps its
    ``_super_block`` in ``jax.checkpoint``: its activations are recomputed
    in the backward instead of kept.  The prefix and suffix layers are
    not checkpointed, as in the reference."""
    kinds = cfg.layer_kinds
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(ids, x, aux_total):
        for i in ids:
            x, aux = apply_layer(layers[i], x, cos, sin, cfg, kinds[i])
            aux_total = aux_total + aux
        return x, aux_total

    pre, scanned, suffix = stack_plan(cfg)
    n_periods = len(scanned[0]) if scanned and scanned[0] else 0
    periods = [[scanned[j][i] for j in range(cfg.period)]
               for i in range(n_periods)]
    remat = cfg.remat and torch.is_grad_enabled()
    x, aux_total = run(pre, x, aux_total)
    for ids in periods:
        if remat:
            x, aux_total = checkpoint(run, ids, x, aux_total,
                                      use_reentrant=False)
        else:
            x, aux_total = run(ids, x, aux_total)
    return run(suffix, x, aux_total)


def prefill_stack(layers, caches, x, cos, sin, cfg: ModelConfig):
    """Prompt forward through all layers, writing caches."""
    new = []
    for layer, kind, cache in zip(layers, cfg.layer_kinds, caches):
        x, c = prefill_layer(layer, x, cos, sin, cfg, kind, cache)
        new.append(c)
    return x, new


def decode_stack(layers, caches, x, cos, sin, cfg: ModelConfig, pos: int):
    """One-token decode through all layers.  Returns (x, caches)."""
    new = []
    for layer, kind, cache in zip(layers, cfg.layer_kinds, caches):
        x, c = decode_layer(layer, x, cos, sin, cfg, kind, cache, pos)
        new.append(c)
    return x, new


def init_caches(cfg: ModelConfig, batch: int, seq: int, dtype, device):
    """One cache dict per layer, in layer order."""
    return [init_layer_cache(cfg, kind, batch, seq, dtype, device)
            for kind in cfg.layer_kinds]
