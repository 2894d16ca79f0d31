"""DeepSeek-V2-Lite 16B [moe] — MLA (kv_lora=512) + 2 shared / 64 routed
top-6 experts, first layer dense.  [arXiv:2405.04434; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,           # dense (first-k) MLP width
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    d_expert=1408,
    first_k_dense=1,
    rope_theta=10000.0,
    max_seq_len=32768,
)
