"""llava-next-mistral-7b — exact assigned config.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] mistral-7B backbone:
32L d4096 32H kv=8 dff 14336 vocab 32000; anyres tiling is a stub
(patch embeddings prepended to the sequence).
"""

from .base import ModelConfig

# [hf:llava-hf/llava-v1.6-mistral-7b-hf] mistral-7B backbone:
# 32L d4096 32H kv=8 dff 14336 vocab 32000; anyres tiling is a stub
# (patch embeddings prepended to the sequence).
CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, rope_theta=1000000.0, n_img_tokens=576,
    # tuned (EXPERIMENTS §Perf-1): coarser q-chunks cut per-chunk
    # collective overhead 2.4x while staying within HBM
    attn_q_chunk=1024,
)
