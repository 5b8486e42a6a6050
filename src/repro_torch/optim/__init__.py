"""Optimizers (counterpart of ``repro.optim``): AdamW and int8 gradient
compression with error feedback."""

from .adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    apply_opt,
    cosine_schedule,
    global_norm,
    init_opt,
)
from .compression import (  # noqa: F401
    compress_grads,
    compressed_psum,
    decompress_grads,
    error_feedback_update,
)
