"""SmolLM-135M [dense] — small llama-arch, GQA kv=3.
[hf:HuggingFaceTB/SmolLM-135M]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    attn_type="full",
    tie_embeddings=True,
    max_seq_len=32768,
)
