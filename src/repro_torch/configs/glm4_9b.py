"""glm4-9b — exact assigned config.

[hf:THUDM/glm-4-9b] 40L d4096 32H GQA kv=2 dff 13696 vocab 151552, RoPE
"""

from .base import ModelConfig

# [hf:THUDM/glm-4-9b] 40L d4096 32H GQA kv=2 dff 13696 vocab 151552, RoPE
CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151552,
    head_dim=128, rope_theta=10000.0, qkv_bias=True,
    # tuned (EXPERIMENTS §Perf-1): coarser q-chunks cut per-chunk
    # collective overhead 2.4x while staying within HBM
    attn_q_chunk=1024,
)
