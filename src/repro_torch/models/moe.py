"""Mixture-of-Experts MLP: shared experts + routed top-k, sort-based
dispatch (port of ``repro.models.moe``).

Token->expert assignments are sorted by expert id (a stable sort, as
``jnp.argsort`` is), slotted into fixed-capacity expert buffers
(drop-on-overflow), run as one batched (E, C, d)x(E, d, f) product and
combined back with routing weights.  The aux load-balancing loss follows
Switch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import MLP, ModelConfig, new_param, normal_init, swiglu


def _expert_shapes(cfg: ModelConfig):
    return cfg.d_model, cfg.d_expert or cfg.d_ff


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, de = _expert_shapes(cfg)
        e, dt = cfg.n_experts, cfg.pdtype()
        self.router = new_param((d, e), torch.float32, device)
        self.w_gate = new_param((e, d, de), dt, device)
        self.w_up = new_param((e, d, de), dt, device)
        self.w_down = new_param((e, de, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, de * cfg.n_shared_experts, dt, device)

    def init(self, gen):
        d, de = self.w_gate.shape[1:]
        normal_init(self.router, gen, d**-0.5)
        normal_init(self.w_gate, gen, d**-0.5)
        normal_init(self.w_up, gen, d**-0.5)
        normal_init(self.w_down, gen, de**-0.5)
        if hasattr(self, "shared"):
            self.shared.init(gen)


def _expert_counts(flat_e, e: int):
    """Assignments per expert, (E,) int64: a scatter-add, which unlike
    ``torch.bincount`` on the card needs no read of the ids' maximum on
    the host."""
    return torch.zeros(e, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def moe_route(p, xt, cfg: ModelConfig):
    """The routing of ``xt`` (T, D): a dict of the gate weights (T, k) in
    x's dtype, the router probs (T, E) and the integers of the dispatch —
    ``expert`` (T, k), ``order`` (T*k,) (the stable sort of the flat
    expert ids), ``keep`` and ``slot`` (T*k,) in sorted order, and
    ``cap``.  Top-k takes the lower expert id first on equal probs (the
    reference's ``lax.top_k``), through a stable descending sort."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t = xt.shape[0]
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = srt[:, :k], idx[:, :k]
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(
        xt.dtype)
    # capacity follows T, so padding a batch changes what is dropped
    cap = int(max(1, cfg.moe_capacity_factor * t * k / e))
    flat_e = expert.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # group by expert
    sorted_e = flat_e[order]
    counts = _expert_counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = rank < cap
    slot = sorted_e * cap + torch.clamp(rank, 0, cap - 1)
    return {"gate": gate, "probs": probs, "expert": expert, "order": order,
            "keep": keep, "slot": slot, "cap": cap}


def moe_apply(p, x, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    r = moe_route(p, xt, cfg)
    cap, order, keep, slot = r["cap"], r["order"], r["keep"], r["slot"]

    # Switch aux loss: fraction of tokens routed * mean router prob
    me = r["probs"].mean(dim=0)
    ce = _expert_counts(r["expert"].reshape(-1), e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    token_of = order // k  # token index of each sorted assignment
    # dispatch into (E*cap, d) buffers; a dropped assignment writes the
    # spare row E*cap, which is cut off (the reference's mode="drop")
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, e * cap)] = xt[token_of]
    buf = buf[: e * cap].reshape(e, cap, d)

    g = F.silu(torch.bmm(buf, p.w_gate))
    u = torch.bmm(buf, p.w_up)
    y = torch.bmm(g * u, p.w_down).reshape(e * cap, d)

    # combine: each token sums its k weighted expert outputs in sorted
    # (expert id) order, the order of the reference's scatter-add, with
    # no atomics (deterministic on the card)
    y_tok = torch.where(keep[:, None], y[slot], 0.0)
    w = r["gate"].reshape(-1)[order]
    contrib = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    contrib[order] = y_tok * w[:, None]
    by_expert = torch.argsort(r["expert"], dim=-1, stable=True)
    contrib = torch.take_along_dim(contrib.reshape(t, k, d),
                                   by_expert[:, :, None], dim=1)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        sp = p.shared
        out = out + swiglu(xt, sp.w_gate, sp.w_up, sp.w_down)
    return out.reshape(b, s, d), aux
