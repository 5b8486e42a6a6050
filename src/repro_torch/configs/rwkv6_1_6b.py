"""rwkv6-1.6b — exact assigned config.

[arXiv:2404.05892] Finch: 24L d2048 attn-free dff 7168 vocab 65536
"""

from .base import ModelConfig

# [arXiv:2404.05892] Finch: 24L d2048 attn-free dff 7168 vocab 65536
CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab_size=65536,
    head_dim=64, rwkv_head_dim=64,
)
