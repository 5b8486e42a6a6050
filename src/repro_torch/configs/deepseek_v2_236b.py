"""deepseek-v2-236b — exact assigned config.

[arXiv:2405.04434] 60L d5120 128H, MLA (kv_lora 512, q_lora 1536,
rope_hd 64, nope_hd 128, v_hd 128), MoE: 160 routed (dff 1536) top-6
+ 2 shared, first layer dense (dff 12288 -> d_ff).
"""

from .base import ModelConfig

# [arXiv:2405.04434] 60L d5120 128H, MLA (kv_lora 512, q_lora 1536,
# rope_hd 64, nope_hd 128, v_hd 128), MoE: 160 routed (dff 1536) top-6
# + 2 shared, first layer dense (dff 12288 -> d_ff).
CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
    head_dim=192, rope_theta=10000.0,
    n_experts=160, moe_top_k=6, d_ff_expert=1536, n_shared_experts=2,
    n_dense_layers=1,
    # tuned (EXPERIMENTS §Perf-2/B): a2a EP + matrix-absorbed MLA decode
    moe_impl="a2a", mla_absorb=True,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
)
