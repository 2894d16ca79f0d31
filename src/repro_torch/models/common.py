"""Shared model-substrate pieces of the port: the config schema, init
helpers, norms, RoPE (port of ``repro.models.common``).

Every block is an ``nn.Module`` whose parameter names are the reference's
pytree keys; the math lives in plain functions named after the
reference's, which take the block as ``p``.  All shapes and dtypes flow
from ``ModelConfig``, so the same code serves the 135M..33B configs and
the reduced smoke variants.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ModelConfig", "round_up", "normal_init", "rms_norm",
           "rope_angles", "apply_rope", "swiglu", "causal_mask",
           "local_mask", "causal_conv", "MLP", "new_param"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int  # logical
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention variant
    attn_type: str = "full"  # full | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # layer pattern: per-period block kinds; tiled/truncated to n_layers.
    # kinds: "attn" (type per attn_type), "local" (sliding window attn),
    #        "ssm" (mamba2), "rglru" (griffin recurrent block)
    pattern: Sequence[str] = ("attn",)
    local_window: int = 1024

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    v_head_dim: int = 0  # 0 -> d_head

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 1
    d_expert: int = 0  # routed-expert FFN width (0 -> d_ff)
    first_k_dense: int = 0  # leading layers use a dense MLP (deepseek style)
    moe_capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # RG-LRU (recurrentgemma)
    rglru_expand: int = 1  # d_rnn = rglru_expand * d_model (9b uses ~1.0)
    rglru_conv: int = 4

    # modality frontend stub (audio/vlm): length of precomputed prefix embeds
    prefix_len: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # The reference's compile-time and sharding knobs.  The port accepts
    # them so a config carries across unchanged; its layer stack is a
    # Python loop either way (scan_layers, scan_loss).  pure_dp and zero1
    # steer the sharding rules (parallel/sharding.py); remat checkpoints
    # each scanned period of the layer stack in the backward
    # (transformer.apply_stack).
    scan_layers: bool = True
    scan_loss: bool = True
    pure_dp: bool = False
    remat: bool = False
    zero1: bool = False
    # bf16_norm: keep the residual stream in its own dtype through rms_norm
    # (the variance still accumulates in f32)
    bf16_norm: bool = False
    # mla_materialize: full-sequence MLA paths (train/prefill) materialize
    # K/V from the latent instead of the absorbed form (decode stays
    # absorbed, its cache latent-sized)
    mla_materialize: bool = False
    vocab_pad_to: int = 256
    tie_embeddings: bool = False
    loss_chunk: int = 512  # seq chunk for the chunked xent loss

    # serving
    max_seq_len: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer block kind, pattern tiled to n_layers."""
        p = list(self.pattern)
        kinds = (p * ((self.n_layers + len(p) - 1) // len(p)))[: self.n_layers]
        return tuple(kinds)

    @property
    def period(self) -> int:
        return len(self.pattern)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Total parameters, counted on a model built on the meta device
        (no storage is allocated)."""
        from .model import LM

        return sum(p.numel() for p in LM(self, device="meta").parameters())


# ----------------------------------------------------------------- layers


def new_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``init_params`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def normal_init(param: torch.Tensor, gen: torch.Generator, scale: float):
    """The reference's ``normal_init``: a float32 standard normal draw times
    ``scale``, cast to the parameter's dtype."""
    draw = torch.randn(param.shape, generator=gen, dtype=torch.float32,
                       device=param.device)
    param.copy_(draw * scale)


def rms_norm(x, gamma, eps: float = 1e-6, *, upcast: bool = True):
    """RMSNorm with the ``(1 + gamma)`` gain.  ``upcast=False`` keeps the
    (B,S,D) tensor in its input dtype; the variance still accumulates in
    f32 (the reference's bf16_norm variant)."""
    if upcast:
        dt = x.dtype
        x = x.float()
        var = torch.mean(x * x, dim=-1, keepdim=True)
        out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
        return out.to(dt)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma.float()).to(x.dtype)


def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), in float32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (float(theta) ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D) with cos/sin (S, D/2) or broadcastable."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, device=None):
    """(s_q, s_k) bool; True = attend.  q position i attends k positions
    <= i."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return kj <= qi


def local_mask(s_q: int, s_k: int, window: int, q_offset: int = 0,
               device=None):
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv along S, plus the bias.  ``state`` (B, K-1, C)
    is the decode carry; returns (out, new state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = full[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + full[:, i: i + s, :] * w[i][None, None, :]
    new_state = full[:, -(k - 1):, :] if k > 1 else None
    return out + b, new_state


class MLP(nn.Module):
    """A dense SwiGLU MLP's weights (``w_gate``, ``w_up``, ``w_down``)."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.w_gate = new_param((d, f), dtype, device)
        self.w_up = new_param((d, f), dtype, device)
        self.w_down = new_param((f, d), dtype, device)

    def init(self, gen):
        d, f = self.w_gate.shape
        normal_init(self.w_gate, gen, d**-0.5)
        normal_init(self.w_up, gen, d**-0.5)
        normal_init(self.w_down, gen, f**-0.5)

    def forward(self, x):
        return swiglu(x, self.w_gate, self.w_up, self.w_down)
