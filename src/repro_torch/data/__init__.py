"""Training data (counterpart of ``repro.data``): the synthetic LM stream."""

from .synthetic import SyntheticLM, host_batch  # noqa: F401
