"""minitron-8b — exact assigned config.

[arXiv:2407.14679] pruned nemotron: 32L d4096 32H kv=8 dff 16384 v256000
"""

from .base import ModelConfig

# [arXiv:2407.14679] pruned nemotron: 32L d4096 32H kv=8 dff 16384 v256000
CONFIG = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab_size=256000,
    head_dim=128, rope_theta=10000.0,
    # tuned (EXPERIMENTS §Perf-1): coarser q-chunks cut per-chunk
    # collective overhead 2.4x while staying within HBM
    attn_q_chunk=1024,
)
