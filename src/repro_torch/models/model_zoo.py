"""Model registry: config -> model instance (counterpart of ``repro.models.model_zoo``).

Every model exposes::

    init(generator) -> params
    param_spec() -> {name: (shape, init)}
    forward(params, tokens) -> (logits, aux)

and ``prefill`` / ``decode_step`` / ``init_cache``, which the generation
engine serves; where it trains, ``loss(params, batch)`` (``DecoderLM``).
The RWKV6 (``ssm``) family serves; the dense family serves and trains.
The others name the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig

from .rwkv6 import Rwkv6LM
from .transformer import DecoderLM

__all__ = ["get_model"]

#: family -> where ROADMAP.md queues its port
_NOT_YET = {
    "moe": "ROADMAP.md §1 slice 5, item 8 (MoE and MLA)",
    "vlm": "ROADMAP.md §1 slice 5, item 7 (the VLM front end)",
    "hybrid": "ROADMAP.md §1 slice 5, item 7 (RG-LRU)",
    "encdec": "ROADMAP.md §1 slice 5, item 7 (Whisper)",
}


def get_model(cfg: ModelConfig, device: Any = "cuda"):
    if cfg.family == "ssm":
        return Rwkv6LM(cfg, device=device)
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"repro_torch has no {cfg.family!r} model yet ({cfg.name}); "
            f"its port is queued in {_NOT_YET[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
