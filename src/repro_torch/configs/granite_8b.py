"""granite-8b — exact assigned config.

[arXiv:2405.04324] llama-arch code model: 36L d4096 32H kv=8 dff 14336
"""

from .base import ModelConfig

# [arXiv:2405.04324] llama-arch code model: 36L d4096 32H kv=8 dff 14336
CONFIG = ModelConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=49152,
    head_dim=128, rope_theta=10000000.0,
    # tuned (EXPERIMENTS §Perf-1): coarser q-chunks cut per-chunk
    # collective overhead 2.4x while staying within HBM
    attn_q_chunk=1024,
)
