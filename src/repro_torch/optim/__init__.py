"""Optimizers (counterpart of ``repro.optim``): AdamW."""

from .adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    apply_opt,
    cosine_schedule,
    global_norm,
    init_opt,
)
