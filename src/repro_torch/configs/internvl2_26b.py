"""InternVL2-26B [vlm] — InternLM2 backbone (GQA kv=8); InternViT frontend is
a stub (precomputed patch embeddings).  [arXiv:2404.16821; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    attn_type="full",
    prefix_len=256,       # stubbed ViT patch embeddings
    rope_theta=1000000.0,
    max_seq_len=32768,
)
