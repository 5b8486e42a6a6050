"""whisper-small — exact assigned config.

[arXiv:2212.04356] enc-dec 12L+12L d768 12H dff 3072 vocab 51865;
conv frontend is a stub (input_specs provides frame embeddings).
"""

from .base import ModelConfig

# [arXiv:2212.04356] enc-dec 12L+12L d768 12H dff 3072 vocab 51865;
# conv frontend is a stub (input_specs provides frame embeddings).
CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    head_dim=64, n_encoder_layers=12, n_audio_ctx=1500,
)
