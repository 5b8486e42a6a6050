"""Checkpoints (counterpart of ``repro.checkpoint``)."""

from .ckpt import AsyncCheckpointer, latest_step, restore, save  # noqa: F401
