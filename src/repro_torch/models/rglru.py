"""RG-LRU recurrent block (Griffin / RecurrentGemma temporal mixing; port
of ``repro.models.rglru``).

    r_t = sigmoid(W_r u_t + b_r)          recurrence gate
    i_t = sigmoid(W_i u_t + b_i)          input gate
    a_t = exp(-c * softplus(L) * r_t)     per-channel learned decay (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Training/prefill evaluates the diagonal linear recurrence with a
log-depth scan over the sequence (``linear_scan``, the reference's
``lax.associative_scan``); decode is the O(1) step.  The full temporal
block is: conv1d -> RG-LRU on one branch, GeLU gate on the other, merged
by an output projection (Griffin Fig. 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, causal_conv, new_param, normal_init

_C = 8.0


def rnn_width(cfg: ModelConfig) -> int:
    return cfg.rglru_expand * cfg.d_model


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dr, dt = cfg.d_model, rnn_width(cfg), cfg.pdtype()
        f32 = torch.float32
        self.w_x = new_param((d, dr), dt, device)
        self.w_gate = new_param((d, dr), dt, device)
        self.conv_w = new_param((cfg.rglru_conv, dr), dt, device)
        self.conv_b = new_param((dr,), dt, device)
        self.w_r = new_param((dr, dr), f32, device)
        self.b_r = new_param((dr,), f32, device)
        self.w_i = new_param((dr, dr), f32, device)
        self.b_i = new_param((dr,), f32, device)
        # softplus(lambda_raw) ~ uniform in a stable decay range
        self.lambda_raw = new_param((dr,), f32, device)
        self.w_out = new_param((dr, d), dt, device)

    @torch.no_grad()
    def init(self, gen):
        d, dr = self.w_x.shape
        normal_init(self.w_x, gen, d**-0.5)
        normal_init(self.w_gate, gen, d**-0.5)
        normal_init(self.conv_w, gen, 0.5)
        self.conv_b.zero_()
        normal_init(self.w_r, gen, dr**-0.5)
        self.b_r.zero_()
        normal_init(self.w_i, gen, dr**-0.5)
        self.b_i.zero_()
        self.lambda_raw.copy_(torch.linspace(0.2, 1.2, dr,
                                             dtype=torch.float32))
        normal_init(self.w_out, gen, dr**-0.5)


def _gates(p, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p.w_r + p.b_r)
    i = torch.sigmoid(uf @ p.w_i + p.b_i)
    log_a = -_C * F.softplus(p.lambda_raw) * r  # (..., dr), <= 0
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated_in


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, as a
    Hillis-Steele scan of the pairs (a, b) under (al, bl) o (ar, br) =
    (al ar, bl ar + br): log2(S) steps of O(S) work.  The same
    recurrence as the reference's associative scan in another float
    order."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], b_prev * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        off *= 2
    return b


def _temporal(p, x, u):
    """The merged block output from the conv'd branch ``u``; also h."""
    a, gin = _gates(p, u)
    h = linear_scan(a, gin)
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    y = gate * h.to(x.dtype)
    return y @ p.w_out, h


def rglru_apply(p, x, cfg: ModelConfig):
    """Training/prefill forward.  x (B,S,D) -> (B,S,D)."""
    u, _ = causal_conv(x @ p.w_x, p.conv_w, p.conv_b)
    return _temporal(p, x, u)[0]


def rglru_prefill(p, x, cfg: ModelConfig, cache):
    """Prompt forward, returning recurrent + conv state for decode."""
    u, conv_state = causal_conv(x @ p.w_x, p.conv_w, p.conv_b)
    out, h = _temporal(p, x, u)
    return out, {"conv": conv_state.to(cache["conv"].dtype),
                 "h": h[:, -1].float()}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device):
    dr = rnn_width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru_conv - 1, dr), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x, cfg: ModelConfig, cache):
    """One-token decode.  x (B,1,D)."""
    u, conv_state = causal_conv(x @ p.w_x, p.conv_w, p.conv_b,
                                 state=cache["conv"])
    a, gin = _gates(p, u[:, 0])
    h = a * cache["h"] + gin
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    y = gate[:, 0] * h.to(x.dtype)
    return (y @ p.w_out)[:, None, :], {"conv": conv_state, "h": h}
