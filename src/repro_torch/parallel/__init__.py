"""repro_torch.parallel — expert parallelism and the pipeline.

:mod:`repro_torch.parallel.moe_a2a` is the counterpart of
``repro.parallel.moe_a2a``: the MoE layer with its expert-parallel
all-to-all run as a certified schedule, in the plan's rank order, on the
virtual mesh or over a process group.  :mod:`repro_torch.parallel.pipeline`
is the counterpart of ``repro.parallel.pipeline``: GPipe over a stage axis.
"""

from .pipeline import pipeline_forward, pipeline_loss  # noqa: F401
