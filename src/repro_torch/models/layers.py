"""Shared layers (the part of ``repro.models.layers`` the port's models use)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["dense_init", "rms_norm"]


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 from ``generator``, then cast.

    ``scale`` defaults to ``1/sqrt(shape[0])`` (fan-in of an ``[in, out]``
    weight used as ``x @ w``).  The tensor lies on the generator's device.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mixed-precision RMSNorm, as the reference computes it: the variance
    in f32, the scale cast to ``x.dtype``, then ``x * scale * w``."""
    var = x.float().square().mean(-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)
