"""GQA attention (full / sliding-window), RoPE, qk-norm; train + decode
paths (port of ``repro.models.attention``)."""

from __future__ import annotations

import torch
from torch import nn

from .common import (ModelConfig, apply_rope, causal_mask, local_mask,
                     new_param, normal_init, rms_norm)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh, dv, dt = cfg.head_dim, cfg.v_dim, cfg.pdtype()
        self.wq = new_param((d, h * dh), dt, device)
        self.wk = new_param((d, kv * dh), dt, device)
        self.wv = new_param((d, kv * dv), dt, device)
        self.wo = new_param((h * dv, d), dt, device)
        if cfg.qk_norm:
            self.q_gamma = new_param((dh,), dt, device)
            self.k_gamma = new_param((dh,), dt, device)

    @torch.no_grad()
    def init(self, gen):
        s = self.wq.shape[0] ** -0.5
        for w in (self.wq, self.wk, self.wv):
            normal_init(w, gen, s)
        normal_init(self.wo, gen, self.wo.shape[0] ** -0.5)
        if hasattr(self, "q_gamma"):
            self.q_gamma.zero_()
            self.k_gamma.zero_()


def _qkv(p, x, cos, sin, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kv, dh, dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_dim
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, kv, dh)
    v = (x @ p.wv).reshape(b, s, kv, dv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_gamma)
        k = rms_norm(k, p.k_gamma)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,S,H,dh), k/v (B,T,KV,*); grouped-query attention under
    ``mask`` (S, T).  Scores leave the product in the compute dtype and
    are scaled, masked with -1e30 and soft-maxed in float32; the probs
    are cast back to v's dtype before the second product (the
    reference's op order)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores * (dh**-0.5)
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkv->bskgv", probs, v)
    return out.reshape(b, s, h * v.shape[-1])


def _full_mask(s: int, window: int, device):
    return (local_mask(s, s, window, device=device) if window
            else causal_mask(s, s, device=device))


def attn_apply(p, x, cos, sin, cfg: ModelConfig, *, window: int = 0):
    """Training/prefill forward.  window>0 -> sliding-window attention."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    out = _sdpa(q, k, v, _full_mask(x.shape[1], window, x.device), cfg)
    return out @ p.wo


def init_kv_cache(cfg: ModelConfig, batch: int, slots: int, dtype, device):
    """Ring-buffer KV cache.  ``slots`` = seq for full attention, window for
    sliding-window layers; one code path covers both (slot = pos % slots,
    masking from the per-slot absolute-position map)."""
    kv, dh, dv = cfg.n_kv_heads, cfg.head_dim, cfg.v_dim
    return {
        "k": torch.zeros((batch, slots, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, kv, dv), dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }


def _ring_mask(pos_map, pos: int, window: int):
    m = (pos_map >= 0) & (pos_map <= pos)
    if window:
        m = m & (pos_map > pos - window)
    return m[None, :]  # (1, slots) -> broadcast over query dim


def attn_prefill(p, x, cos, sin, cfg: ModelConfig, cache, *, window: int = 0):
    """Forward over a prompt, writing the (last ``slots``) KV into the ring.
    Updates ``cache`` in place and returns it."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    s = x.shape[1]
    slots = cache["k"].shape[1]
    w = min(s, slots)
    slot_idx = (torch.arange(w, device=x.device) + (s - w)) % slots
    cache["k"][:, slot_idx] = k[:, s - w:].to(cache["k"].dtype)
    cache["v"][:, slot_idx] = v[:, s - w:].to(cache["v"].dtype)
    cache["pos"][slot_idx] = torch.arange(s - w, s, dtype=torch.int32,
                                          device=x.device)
    out = _sdpa(q, k, v, _full_mask(s, window, x.device), cfg)
    return out @ p.wo, cache


def attn_decode(p, x, cos, sin, cfg: ModelConfig, cache, pos: int, *,
                window: int = 0):
    """One-token decode.  x (B,1,D); ring cache; ``pos`` the absolute
    (0-based) position.  The write lands in slot ``pos % slots``, always
    inside the ring, so the reference's clamped dynamic slice never
    clamps here.  Updates ``cache`` in place and returns it."""
    q, k, v = _qkv(p, x, cos, sin, cfg)  # s = 1
    slot = int(pos) % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = int(pos)
    mask = _ring_mask(cache["pos"], int(pos), window)
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg)
    return out @ p.wo, cache
