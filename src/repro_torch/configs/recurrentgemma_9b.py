"""recurrentgemma-9b — exact assigned config.

[arXiv:2402.19427] Griffin-arch: 38L d4096 16H MQA kv=1 dff 12288
v256000; RG-LRU + local attention window 2048, pattern (R, R, A).
"""

from .base import ModelConfig

# [arXiv:2402.19427] Griffin-arch: 38L d4096 16H MQA kv=1 dff 12288
# v256000; RG-LRU + local attention window 2048, pattern (R, R, A).
CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000,
    head_dim=256, attn_window=2048, block_pattern=("R", "R", "A"),
    rglru_conv_width=4, rope_theta=10000.0,
)
