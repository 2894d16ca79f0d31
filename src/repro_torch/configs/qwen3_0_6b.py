"""Qwen3-0.6B [dense] — GQA kv=8, qk-norm, head_dim 128.  [hf:Qwen/Qwen3]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab_size=151936,
    attn_type="full",
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    max_seq_len=32768,
)
