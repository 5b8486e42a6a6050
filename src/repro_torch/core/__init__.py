"""Numpy planning primitives copied from ``repro.core`` (only ``Flow`` so far)."""

from .schedule import Flow  # noqa: F401
