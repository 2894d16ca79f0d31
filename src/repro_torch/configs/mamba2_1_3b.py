"""Mamba2-1.3B [ssm] — attention-free SSD stack.  [arXiv:2405.21060]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,               # mixing-only blocks
    vocab_size=50280,
    attn_type="none",
    pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq_len=1048576,
)
