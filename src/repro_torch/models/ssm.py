"""Mamba-2 (SSD — state-space duality) mixing layer (port of
``repro.models.ssm``).

Training/prefill uses the chunked SSD algorithm: intra-chunk terms are
dense (L-masked) products; inter-chunk terms flow through a linear
recurrence over per-chunk states (a loop over the chunks, the reference's
``lax.scan``).  Decode keeps the O(1)-in-seq recurrent state.

Conventions (n_groups = 1):
  x:  (B, S, H, P)   inputs per head        (d_inner = H * P)
  dt: (B, S, H)      softplus-discretized step
  A:  (H,)           negative scalar decay per head
  B,C:(B, S, N)      shared input/output projections (N = ssm_state)
  h:  (B, H, P, N)   recurrent state
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (ModelConfig, causal_conv, new_param, normal_init,
                     rms_norm)


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.pdtype()
        d_inner, h, _, n = dims(cfg)
        conv_ch = d_inner + 2 * n  # x, B, C go through the causal conv
        # w_in's columns: [z (gate), x, B, C, dt]
        self.w_in = new_param((d, 2 * d_inner + 2 * n + h), dt, device)
        self.conv_w = new_param((cfg.ssm_conv, conv_ch), dt, device)
        self.conv_b = new_param((conv_ch,), dt, device)
        self.a_log = new_param((h,), torch.float32, device)  # A = -exp(a_log)
        self.dt_bias = new_param((h,), torch.float32, device)
        self.d_skip = new_param((h,), torch.float32, device)
        self.norm_gamma = new_param((d_inner,), dt, device)
        self.w_out = new_param((d_inner, d), dt, device)

    @torch.no_grad()
    def init(self, gen):
        h = self.a_log.shape[0]
        normal_init(self.w_in, gen, self.w_in.shape[0] ** -0.5)
        normal_init(self.conv_w, gen, 0.5)
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h,
                                                  dtype=torch.float32)))
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.norm_gamma.zero_()
        normal_init(self.w_out, gen, self.w_out.shape[0] ** -0.5)


def _split_proj(p, u, cfg: ModelConfig):
    d_inner, _, _, n = dims(cfg)
    zxbcdt = u @ p.w_in
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv along S, then SiLU.  state (B, K-1, C) for
    decode carry."""
    out, new_state = causal_conv(xbc, w, b, state)
    return F.silu(out), new_state


def _segsum(log_a):
    """(..., L) -> (..., L, L) lower-tri cumulative sums: sum_{j<i..} log_a."""
    l = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD.  x (B,S,H,P), dt (B,S,H), a (H,) negative, b/c (B,S,N).

    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    bsz, s, h, p_ = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xr = x.reshape(bsz, nc, chunk, h, p_)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b.reshape(bsz, nc, chunk, n)
    cr = c.reshape(bsz, nc, chunk, n)

    log_a = (dtr * a[None, None, None, :]).movedim(-1, 2)  # (B,NC,H,L) <= 0
    seg = _segsum(log_a)  # (B,NC,H,L,L)

    # intra-chunk (dual / attention-like) term
    lmat = torch.exp(seg)  # decay from j to i, lower-tri
    cb = torch.einsum("bzln,bzmn->bzlm", cr, br)  # (B,NC,L,L)
    xdt = xr * dtr[..., None]  # (B,NC,L,H,P)
    y_intra = torch.einsum("bzlm,bzhlm,bzmhp->bzlhp", cb, lmat, xdt)

    # per-chunk input state: decay from position m to chunk end
    a_cum = torch.cumsum(log_a, dim=-1)  # (B,NC,H,L)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    chunk_state = torch.einsum("bzmn,bzhm,bzmhp->bzhpn", br, decay_to_end,
                               xdt)  # (B,NC,H,P,N)

    # inter-chunk recurrence over chunk states; h_in[z] is the state
    # entering chunk z
    a_chunk = torch.exp(a_cum[..., -1])  # (B,NC,H) total chunk decay
    hstate = torch.zeros((bsz, h, p_, n), dtype=x.dtype, device=x.device)
    h_in = []
    for z in range(nc):
        h_in.append(hstate)
        hstate = hstate * a_chunk[:, z, :, None, None] + chunk_state[:, z]
    h_in = torch.stack(h_in, dim=1)  # (B,NC,H,P,N)

    # inter-chunk output: decay from chunk start to position l
    decay_from_start = torch.exp(a_cum)  # (B,NC,H,L)
    y_inter = torch.einsum("bzln,bzhl,bzhpn->bzlhp", cr, decay_from_start,
                           h_in)
    y = (y_intra + y_inter).reshape(bsz, s, h, p_)
    return y, hstate


def _ssm_fwd(p, u, cfg: ModelConfig):
    d_inner, h, p_, n = dims(cfg)
    bsz, s, _ = u.shape
    z, xbc_raw, dt = _split_proj(p, u, cfg)
    xbc, conv_state = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    x = xbc[..., :d_inner].reshape(bsz, s, h, p_)
    b = xbc[..., d_inner: d_inner + n]
    c = xbc[..., d_inner + n:]
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s  # single chunk when the prompt is not a multiple
    y, hlast = ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk)
    y = y + x.float() * p.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p.norm_gamma)
    return y @ p.w_out, hlast, conv_state


def ssm_apply(p, u, cfg: ModelConfig):
    """Training forward.  u (B,S,D) -> (B,S,D)."""
    return _ssm_fwd(p, u, cfg)[0]


def ssm_prefill(p, u, cfg: ModelConfig, cache):
    """Prompt forward, returning the recurrent + conv state for decode."""
    out, hlast, conv_state = _ssm_fwd(p, u, cfg)
    return out, {"conv": conv_state.to(cache["conv"].dtype),
                 "state": hlast.float()}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device):
    d_inner, h, p_, n = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, h, p_, n), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(p, u, cfg: ModelConfig, cache):
    """One-token decode.  u (B,1,D)."""
    d_inner, h, p_, n = dims(cfg)
    bsz = u.shape[0]
    z, xbc, dt = _split_proj(p, u, cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                   state=cache["conv"])
    x = xbc[:, 0, :d_inner].reshape(bsz, h, p_)
    b = xbc[:, 0, d_inner: d_inner + n].float()
    c = xbc[:, 0, d_inner + n:].float()
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)  # (B,H)
    a = -torch.exp(p.a_log)
    da = torch.exp(dt1 * a[None, :])  # (B,H)
    xdt = x.float() * dt1[..., None]  # (B,H,P)
    hnew = cache["state"] * da[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, b)
    y = torch.einsum("bhpn,bn->bhp", hnew, c)
    y = y + x.float() * p.d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p.norm_gamma)
    return y @ p.w_out, {"conv": conv_state, "state": hnew}
