"""Multi-head Latent Attention (DeepSeek-V2): compressed-KV attention
(port of ``repro.models.mla``).

KV is down-projected to a small latent (kv_lora_rank) plus a shared RoPE
key slice; the latent is what the decode cache stores.  Decode uses the
*absorbed* formulation — W_uk folds into the query so scores contract
directly against the cached latent, never re-materializing full K.
DeepSeek-V2-Lite has no Q compression, so queries project directly from
d_model.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ModelConfig, causal_mask, new_param, normal_init, rms_norm


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh, dr, dv, r = (cfg.head_dim, cfg.qk_rope_dim, cfg.v_dim,
                         cfg.kv_lora_rank)
        dt = cfg.pdtype()
        # queries: nope part (dh) + rope part (dr) per head
        self.wq = new_param((d, h * (dh + dr)), dt, device)
        # latent down-projection + shared rope-key slice
        self.w_dkv = new_param((d, r + dr), dt, device)
        self.kv_gamma = new_param((r,), dt, device)
        # latent up-projections
        self.w_uk = new_param((r, h * dh), dt, device)
        self.w_uv = new_param((r, h * dv), dt, device)
        self.wo = new_param((h * dv, d), dt, device)

    @torch.no_grad()
    def init(self, gen):
        d, r = self.wq.shape[0], self.w_uk.shape[0]
        normal_init(self.wq, gen, d**-0.5)
        normal_init(self.w_dkv, gen, d**-0.5)
        self.kv_gamma.zero_()
        normal_init(self.w_uk, gen, r**-0.5)
        normal_init(self.w_uv, gen, r**-0.5)
        normal_init(self.wo, gen, self.wo.shape[0] ** -0.5)


def _rope_1d(x, cos, sin):
    """x (..., S, H, dr) rotated with cos/sin (S, dr/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c, s = cos[..., :, None, :], sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def _project_q(p, x, cos, sin, cfg: ModelConfig):
    b, s, _ = x.shape
    h, dh, dr = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim
    q = (x @ p.wq).reshape(b, s, h, dh + dr)
    return q[..., :dh], _rope_1d(q[..., dh:], cos, sin)


def _latent(p, x, cos, sin, cfg: ModelConfig):
    r = cfg.kv_lora_rank
    ckv = x @ p.w_dkv
    c = rms_norm(ckv[..., :r], p.kv_gamma)
    k_rope = _rope_1d(ckv[..., r:][:, :, None, :], cos, sin)[:, :, 0, :]
    return c, k_rope


def _mla_scores_absorbed(p, q_nope, q_rope, c, k_rope, cfg: ModelConfig):
    """Scores against the latent cache via the absorbed W_uk."""
    h, dh, dr, r = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    w_uk = p.w_uk.reshape(r, h, dh)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    scores = torch.einsum("bshr,btr->bhst", q_eff, c)
    scores = scores + torch.einsum("bshd,btd->bhst", q_rope, k_rope)
    return scores.float() * ((dh + dr) ** -0.5)


def _mla_out(p, probs, c, cfg: ModelConfig):
    h, dv, r = cfg.n_heads, cfg.v_dim, cfg.kv_lora_rank
    w_uv = p.w_uv.reshape(r, h, dv)
    ctx = torch.einsum("bhst,btr->bshr", probs, c)  # context in latent space
    out = torch.einsum("bshr,rhv->bshv", ctx, w_uv)
    return out.reshape(out.shape[0], out.shape[1], h * dv) @ p.wo


def _mla_attend_materialized(p, q_nope, q_rope, c, k_rope, mask, cfg):
    """Full-seq attention with K/V materialized from the latent: the S^2
    term contracts over head_dim (+rope) instead of 2x kv_lora_rank."""
    h, dh, dr, dv, r = (cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim,
                        cfg.v_dim, cfg.kv_lora_rank)
    b = c.shape[0]
    k_nope = torch.einsum("btr,rhd->bthd", c, p.w_uk.reshape(r, h, dh))
    v = torch.einsum("btr,rhv->bthv", c, p.w_uv.reshape(r, h, dv))
    scores = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    scores = scores + torch.einsum("bshd,btd->bhst", q_rope, k_rope)
    scores = scores.float() * ((dh + dr) ** -0.5)
    scores = scores.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthv->bshv", probs, v)
    return out.reshape(b, q_nope.shape[1], h * dv) @ p.wo


def _attend(p, q_nope, q_rope, c, k_rope, cfg):
    """Causal full-sequence attention in the form the config picks."""
    s = c.shape[1]
    mask = causal_mask(s, s, device=c.device)
    if cfg.mla_materialize:
        return _mla_attend_materialized(p, q_nope, q_rope, c, k_rope, mask,
                                        cfg)
    scores = _mla_scores_absorbed(p, q_nope, q_rope, c, k_rope, cfg)
    scores = scores.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(c.dtype)
    return _mla_out(p, probs, c, cfg)


def mla_apply(p, x, cos, sin, cfg: ModelConfig):
    q_nope, q_rope = _project_q(p, x, cos, sin, cfg)
    c, k_rope = _latent(p, x, cos, sin, cfg)
    return _attend(p, q_nope, q_rope, c, k_rope, cfg)


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device):
    return {
        "c": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
    }


def mla_prefill(p, x, cos, sin, cfg: ModelConfig, cache):
    """Prompt forward, writing the latent and rope keys at rows [0, s).
    Updates ``cache`` in place and returns it."""
    q_nope, q_rope = _project_q(p, x, cos, sin, cfg)
    c, k_rope = _latent(p, x, cos, sin, cfg)
    s = x.shape[1]
    if s > cache["c"].shape[1]:
        raise ValueError(f"a prompt of {s} does not fit a latent cache of "
                         f"{cache['c'].shape[1]} rows")
    cache["c"][:, :s] = c.to(cache["c"].dtype)
    cache["kr"][:, :s] = k_rope.to(cache["kr"].dtype)
    return _attend(p, q_nope, q_rope, c, k_rope, cfg), cache


def mla_decode(p, x, cos, sin, cfg: ModelConfig, cache, pos: int):
    """One-token decode at absolute position ``pos``; the write row clamps
    to [0, T-1] as the reference's ``dynamic_update_slice`` start does, and
    the mask keeps rows <= pos.  Updates ``cache`` in place."""
    q_nope, q_rope = _project_q(p, x, cos, sin, cfg)  # s = 1
    c1, kr1 = _latent(p, x, cos, sin, cfg)
    t = cache["c"].shape[1]
    row = min(max(int(pos), 0), t - 1)
    cache["c"][:, row] = c1[:, 0].to(cache["c"].dtype)
    cache["kr"][:, row] = kr1[:, 0].to(cache["kr"].dtype)
    cc, ckr = cache["c"], cache["kr"]
    scores = _mla_scores_absorbed(p, q_nope, q_rope, cc, ckr, cfg)
    mask = torch.arange(t, device=x.device) <= int(pos)
    scores = scores.masked_fill(~mask[None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(cc.dtype)
    return _mla_out(p, probs, cc, cfg), cache
