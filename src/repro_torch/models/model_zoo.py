"""Model registry: config -> model instance (counterpart of ``repro.models.model_zoo``).

Every model exposes::

    init(generator) -> params
    param_spec() -> {name: (shape, init)}
    forward(params, tokens, frontend_embeds=None) -> (logits, aux)
    loss(params, batch) -> scalar

and ``prefill(params, tokens, frontend_embeds=None)`` / ``decode_step`` /
``init_cache``, which the generation engine serves.  The dense, ``moe``
(``DecoderLM`` with MoE blocks, and MLA for deepseek), ``vlm``
(``DecoderLM`` with the anyres stub), ``ssm`` (``Rwkv6LM``), ``hybrid``
(``RecurrentGemmaLM``) and ``encdec`` (``WhisperLM``) families serve.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig

from .rglru import RecurrentGemmaLM
from .rwkv6 import Rwkv6LM
from .transformer import DecoderLM
from .whisper import WhisperLM

__all__ = ["get_model"]


def get_model(cfg: ModelConfig, device: Any = "cuda"):
    if cfg.family == "ssm":
        return Rwkv6LM(cfg, device=device)
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, device=device)
    if cfg.family == "hybrid":
        return RecurrentGemmaLM(cfg, device=device)
    if cfg.family == "encdec":
        return WhisperLM(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
