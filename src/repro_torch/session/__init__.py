"""repro_torch.session — the canonical job mixes (a copy of ``repro.session.mixes``).

The ``Session`` facade and its config tree wait for slice 4b
(ROADMAP.md §1); until then the chain is driven by hand through
:mod:`repro_torch.fabric`, :mod:`repro_torch.plan` and
:func:`repro_torch.train.reducer_from_plan`.
"""

from .mixes import default_mix, serve_mix, train_mix  # noqa: F401
