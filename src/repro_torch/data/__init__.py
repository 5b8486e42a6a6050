"""Training data (counterpart of ``repro.data``): the synthetic LM stream."""

from .synthetic import SyntheticLM, batches, host_batch, make_global_batch  # noqa: F401
