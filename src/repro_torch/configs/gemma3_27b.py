"""Gemma3-27B [dense] — 5:1 local:global attention, window 1024, qk-norm,
head_dim 128, 128k context.  [hf:google/gemma-3; unverified]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    attn_type="full",
    qk_norm=True,
    pattern=("local", "local", "local", "local", "local", "attn"),
    local_window=1024,
    rope_theta=1000000.0,
    max_seq_len=1048576,
)
