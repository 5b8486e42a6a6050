"""repro_torch — the PyTorch/CUDA port of ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package stands
beside it and imports nothing of it (nor JAX).  Module names mirror
``repro``'s so each part has an obvious counterpart:

* :mod:`repro_torch.configs` — ``ModelConfig`` / ``get_config`` (copies);
* :mod:`repro_torch.models` — ``Rwkv6LM`` and ``get_model``;
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels, each with
  its plain PyTorch version beside it;
* :mod:`repro_torch.serve` — the generation engine;
* :mod:`repro_torch.session` — the ``Session`` facade (probe → plan →
  apply → monitor) and its ``SessionConfig``;
* :mod:`repro_torch.train` — the train steps, the planned reducer and the
  fault-tolerant ``Trainer``;
* :mod:`repro_torch.obs` — tracer, metrics and workload recorder;
* :mod:`repro_torch.convert` — JAX parameter trees to torch tensors.

Entry points take a ``device`` that defaults to ``"cuda"`` and raise when
CUDA is absent; the CPU path (the kernels' plain versions) runs only when
the caller passes ``device="cpu"``, as the tests do.

Exports are lazy so ``import repro_torch`` stays cheap.
"""

from __future__ import annotations

import importlib
from typing import Any

__all__ = [
    "GenerationConfig",
    "GenerationEngine",
    "ModelConfig",
    "Session",
    "SessionConfig",
    "Trainer",
    "TrainerConfig",
    "default_device",
    "get_config",
    "get_model",
    "obs",
    "on_cuda",
    "params_from_jax",
    "resolve_device",
]

_LAZY = {
    "GenerationConfig": "repro_torch.serve.engine",
    "GenerationEngine": "repro_torch.serve.engine",
    "ModelConfig": "repro_torch.configs.base",
    "Session": "repro_torch.session",
    "SessionConfig": "repro_torch.session",
    "Trainer": "repro_torch.train",
    "TrainerConfig": "repro_torch.train",
    "get_config": "repro_torch.configs.registry",
    "get_model": "repro_torch.models.model_zoo",
    "params_from_jax": "repro_torch.convert",
}


def on_cuda() -> bool:
    """Whether a CUDA device is present (counterpart of ``ops.on_tpu``)."""
    import torch

    return torch.cuda.is_available()


def default_device():
    """The device entry points run on unless told otherwise: CUDA."""
    import torch

    return torch.device("cuda")


def resolve_device(device: Any = "cuda"):
    """``device`` as a ``torch.device``; raises if it names an absent GPU.

    There is no silent fall-back to the CPU: the CPU runs only when the
    caller asks for it.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available on this machine; pass "
            "device='cpu' (or --device cpu) to run the plain PyTorch path "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def __getattr__(name: str) -> Any:
    if name == "obs":
        return importlib.import_module("repro_torch.obs")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
