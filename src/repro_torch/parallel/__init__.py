"""repro_torch.parallel — expert parallelism on the virtual mesh.

:mod:`repro_torch.parallel.moe_a2a` is the counterpart of
``repro.parallel.moe_a2a``: the MoE layer with its expert-parallel
all-to-all run as a certified schedule, in the plan's rank order.
"""
