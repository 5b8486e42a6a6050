"""qwen2-0.5b — exact assigned config.

[arXiv:2407.10671] 24L d896 14H GQA kv=2 dff 4864 vocab 151936, QKV bias
"""

from .base import ModelConfig

# [arXiv:2407.10671] 24L d896 14H GQA kv=2 dff 4864 vocab 151936, QKV bias
CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151936,
    head_dim=64, rope_theta=1000000.0, qkv_bias=True, tie_embeddings=True,
)
