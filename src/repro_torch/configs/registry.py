"""The 10 assigned architectures (one module per arch, exact public configs).

Each arch is selectable via ``--arch <id>`` in the launchers; sources are
cited in the per-arch modules ([hf:...] / [arXiv:...] as assigned).
"""

from __future__ import annotations

from typing import Dict

from . import (
    dbrx_132b,
    deepseek_v2_236b,
    glm4_9b,
    granite_8b,
    llava_next_mistral_7b,
    minitron_8b,
    qwen2_0_5b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    whisper_small,
)
from .base import ModelConfig

__all__ = ["ARCHS", "get_config", "ARCH_IDS"]

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        glm4_9b,
        qwen2_0_5b,
        granite_8b,
        minitron_8b,
        rwkv6_1_6b,
        recurrentgemma_9b,
        dbrx_132b,
        deepseek_v2_236b,
        whisper_small,
        llava_next_mistral_7b,
    )
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
