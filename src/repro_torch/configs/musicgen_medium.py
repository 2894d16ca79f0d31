"""MusicGen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub (precomputed frame embeddings).  [arXiv:2306.05284; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attn_type="full",
    prefix_len=256,       # stubbed EnCodec conditioning frames
    rope_theta=10000.0,
    max_seq_len=32768,
)
