"""DeepSeek-Coder-33B [dense] — llama-arch GQA kv=8.  [arXiv:2401.14196; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    attn_type="full",
    rope_theta=100000.0,
    max_seq_len=32768,
)
