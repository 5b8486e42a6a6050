"""dbrx-132b — exact assigned config.

[hf:databricks/dbrx-base] 40L d6144 48H kv=8 vocab 100352,
16 experts top-4 with d_ff_expert 10752 (fine-grained).
"""

from .base import ModelConfig

# [hf:databricks/dbrx-base] 40L d6144 48H kv=8 vocab 100352,
# 16 experts top-4 with d_ff_expert 10752 (fine-grained).
CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab_size=100352,
    head_dim=128, rope_theta=500000.0,
    n_experts=16, moe_top_k=4, d_ff_expert=10752,
    # tuned (EXPERIMENTS §Perf-2): shard_map all-to-all EP; falls back
    # to the dense einsum dispatch off-mesh
    moe_impl="a2a",
)
