"""Public model API of the port: init / forward / loss / prefill / decode
for any config (port of ``repro.models.model``).

Inputs:
  forward: tokens (B, S) ints [+ prefix_embeds (B, P, d_model)]
  loss_fn: {"tokens": (B, S), "labels": (B, S)} with -1 = masked
  prefill: tokens (B, S) + caches;  decode_step: token (B, 1), pos int

Tokens may be tensors or numpy arrays; they move to the model's device.
The audio/vlm frontends are stubs: the caller supplies precomputed
frame/patch embeddings, prepended to the token embeddings (loss is on
token positions only).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .common import ModelConfig, new_param, normal_init, rms_norm, rope_angles
from .transformer import (
    Layer,
    apply_stack,
    decode_stack,
    init_caches,
    prefill_stack,
)

__all__ = [
    "LM",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "make_decode_caches",
]


class LM(nn.Module):
    """The model's parameters: ``embed`` (V, D), one ``Layer`` per layer
    in ``layers``, ``final_norm`` and, unless tied, ``unembed`` (D, V)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        v, d, dt = cfg.padded_vocab, cfg.d_model, cfg.pdtype()
        self.embed = new_param((v, d), dt, device)
        self.layers = nn.ModuleList(Layer(cfg, i, device)
                                    for i in range(cfg.n_layers))
        self.final_norm = new_param((d,), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = new_param((d, v), dt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator = None,
                device="cuda") -> LM:
    """A model with random weights on ``device`` (the card by default),
    drawn from ``generator`` (a ``torch.Generator`` on that device; seed 0
    when None) in the reference's distributions."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, dev)
    d = cfg.d_model
    normal_init(model.embed, generator, d**-0.5)
    for layer in model.layers:
        layer.init(generator)
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        normal_init(model.unembed, generator, d**-0.5)
    return model


def _tokens(params, tokens):
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.array(tokens, np.int64))
    return tokens.to(params.device).long()


def _embed(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    x = params.embed[_tokens(params, tokens)].to(cfg.cdtype())
    # the scale rounded to the compute dtype first, as the reference's
    # jnp.asarray(d_model**0.5, cdtype); a Python number needs no copy
    # to the device
    scale = torch.tensor(cfg.d_model**0.5, dtype=cfg.cdtype()).item()
    x = x * scale
    if prefix_embeds is not None:
        pe = torch.as_tensor(prefix_embeds, device=x.device)
        x = torch.cat([pe.to(cfg.cdtype()), x], dim=1)
    return x


def _rope(cfg: ModelConfig, positions):
    dim = cfg.qk_rope_dim if cfg.attn_type == "mla" else cfg.head_dim
    return rope_angles(positions, dim, cfg.rope_theta)


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Full-sequence hidden states.  Returns (x (B,S,D), aux_loss)."""
    x = _embed(params, cfg, tokens, prefix_embeds)
    cos, sin = _rope(cfg, torch.arange(x.shape[1], device=x.device))
    x, aux = apply_stack(params.layers, x, cos, sin, cfg)
    return rms_norm(x, params.final_norm, upcast=not cfg.bf16_norm), aux


def _unembed_weight(params):
    return params.unembed if hasattr(params, "unembed") else params.embed.T


def loss_fn(params, cfg: ModelConfig, batch):
    """Chunked next-token cross-entropy (never materializes (B,S,V) at
    once), plus the z-loss and the MoE aux loss.

    batch: tokens (B,S), labels (B,S) with -1 = masked; optional
    prefix_embeds (prefix positions carry no loss).  Returns (loss,
    metrics)."""
    x, aux = forward(params, cfg, batch["tokens"], batch.get("prefix_embeds"))
    labels = _tokens(params, batch["labels"])
    x = x[:, x.shape[1] - labels.shape[1]:]  # loss on token positions only
    w = _unembed_weight(params)

    b, s, _ = x.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        c = s
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros_like(nll)
    denom = torch.zeros_like(nll)
    for start in range(0, s, c):
        xx, ll = x[:, start:start + c], labels[:, start:start + c]
        logits = (xx @ w).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll.clamp(min=0)[..., None])[..., 0]
        mask = (ll >= 0).float()
        nll = nll + torch.sum((logz - gold) * mask)
        zl = zl + torch.sum((logz**2) * mask)  # z-loss stabilizer
        denom = denom + mask.sum()
    denom = torch.clamp(denom, min=1.0)
    loss = nll / denom + 1e-4 * zl / denom + 0.01 * aux
    return loss, {"nll": nll / denom, "aux": aux, "tokens": denom}


def make_decode_caches(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                       *, device="cuda"):
    """One cache dict per layer for ``batch`` rows and ``seq`` positions,
    on ``device`` (the card by default)."""
    return init_caches(cfg, batch, seq, dtype or cfg.cdtype(),
                       resolve_device(device))


def prefill(params, cfg: ModelConfig, tokens, caches, prefix_embeds=None):
    """Prompt pass: returns (last-position logits (B, V) f32, caches)."""
    x = _embed(params, cfg, tokens, prefix_embeds)
    cos, sin = _rope(cfg, torch.arange(x.shape[1], device=x.device))
    x, caches = prefill_stack(params.layers, caches, x, cos, sin, cfg)
    x = rms_norm(x[:, -1:], params.final_norm, upcast=not cfg.bf16_norm)
    return (x @ _unembed_weight(params))[:, 0].float(), caches


def decode_step(params, cfg: ModelConfig, token, pos: int, caches):
    """One-token decode: token (B,1), pos the absolute position (an int).

    Returns (logits (B, V) f32, caches)."""
    pos = int(pos)
    x = _embed(params, cfg, token)
    cos, sin = _rope(cfg, torch.arange(pos, pos + 1, device=x.device))
    x, caches = decode_stack(params.layers, caches, x, cos, sin, cfg, pos)
    x = rms_norm(x, params.final_norm, upcast=not cfg.bf16_norm)
    return (x @ _unembed_weight(params))[:, 0].float(), caches
