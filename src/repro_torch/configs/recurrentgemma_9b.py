"""RecurrentGemma-9B [hybrid] — Griffin: RG-LRU blocks + MQA local attention
(window 2048), pattern R-R-L.  [arXiv:2402.19427]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,         # MQA
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    attn_type="full",
    pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rglru_expand=1,
    rglru_conv=4,
    max_seq_len=1048576,
)
