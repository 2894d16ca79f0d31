"""Llama-4 Scout 17B-A16E [moe] — 16 routed experts top-1 + 1 shared, GQA
kv=8, early-fusion multimodal (frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    attn_type="full",
    n_experts=16,
    n_shared_experts=1,
    experts_per_token=1,
    d_expert=8192,
    rope_theta=500000.0,
    max_seq_len=32768,
)
