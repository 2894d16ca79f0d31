"""Architecture registry of the port: one module per assigned architecture
(copies of ``repro.configs`` on the port's ``ModelConfig``).

``get_config(name)`` returns the full published config; ``smoke_config(cfg)``
returns a reduced same-family variant for CPU tests.
"""

from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig

from . import (
    deepseek_coder_33b,
    deepseek_v2_lite_16b,
    gemma3_27b,
    internvl2_26b,
    llama4_scout_17b_a16e,
    mamba2_1_3b,
    musicgen_medium,
    qwen3_0_6b,
    recurrentgemma_9b,
    smollm_135m,
    trueknn,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in [
        deepseek_v2_lite_16b,
        llama4_scout_17b_a16e,
        musicgen_medium,
        mamba2_1_3b,
        recurrentgemma_9b,
        deepseek_coder_33b,
        qwen3_0_6b,
        smollm_135m,
        gemma3_27b,
        internvl2_26b,
    ]
}

TRUEKNN_CONFIG = trueknn.CONFIG


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers/experts, f32."""
    heads = 4
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else heads
    changes = dict(
        n_layers=min(cfg.n_layers, cfg.period * 2 + cfg.first_k_dense),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        local_window=32,
        max_seq_len=128,
        loss_chunk=32,
        param_dtype="float32",
        compute_dtype="float32",
        prefix_len=8 if cfg.prefix_len else 0,
        ssm_head_dim=16,
        ssm_state=16,
        ssm_chunk=16,
    )
    if cfg.n_experts:
        changes.update(
            n_experts=min(cfg.n_experts, 8),
            n_shared_experts=min(cfg.n_shared_experts, 1),
            experts_per_token=min(cfg.experts_per_token, 2),
            d_expert=64 if cfg.d_expert else 0,
        )
    if cfg.kv_lora_rank:
        changes.update(kv_lora_rank=32, qk_rope_dim=16, v_head_dim=16)
    return dataclasses.replace(cfg, **changes)
