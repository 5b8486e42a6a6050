"""Model registry: config -> model instance (counterpart of ``repro.models.model_zoo``).

Every model exposes::

    init(generator) -> params
    forward(params, tokens) -> (logits, aux)
    prefill(params, tokens) -> (logits[B,V], cache)
    decode_step(params, tokens[B], cache) -> (logits[B,V], cache')
    init_cache(batch, s_max) -> cache

Only the RWKV6 family is ported so far; the others name the ROADMAP.md
item that ports them.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig

from .rwkv6 import Rwkv6LM

__all__ = ["get_model"]

#: family -> where ROADMAP.md queues its port
_NOT_YET = {
    "dense": "ROADMAP.md §1 slice 2, item 9 (DecoderLM)",
    "moe": "ROADMAP.md §1 slice 4, item 18 (MoE)",
    "vlm": "ROADMAP.md §1 slice 2, item 9 (DecoderLM backbone)",
    "hybrid": "ROADMAP.md §1 slice 4, item 17 (RG-LRU)",
    "encdec": "ROADMAP.md §1 slice 4, item 17 (Whisper)",
}


def get_model(cfg: ModelConfig, device: Any = "cuda"):
    if cfg.family == "ssm":
        return Rwkv6LM(cfg, device=device)
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"repro_torch has no {cfg.family!r} model yet ({cfg.name}); "
            f"its port is queued in {_NOT_YET[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
