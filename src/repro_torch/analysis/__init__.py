"""repro_torch.analysis — the certifier the port's runners rely on.

Copies of the parts of ``repro.analysis`` that the training path needs:

* :mod:`~repro_torch.analysis.equiv` — translation validation: proves a
  :class:`~repro_torch.collective.executors.LoweredSchedule` bisimilar
  to its source Program; :func:`require_certified` is the gate every
  schedule passes before a runner touches it;
* :mod:`~repro_torch.analysis.deps` — the dependency pass that
  :func:`~repro_torch.collective.passes.fuse_rounds` re-checks after
  fusing;
* :mod:`~repro_torch.analysis.report` — findings, reports and
  :class:`VerificationError`.
"""

from .deps import analyze_dependencies, require_acyclic  # noqa: F401
from .equiv import bisimulate, require_certified, symbolic_execute  # noqa: F401
from .report import SEVERITIES, Finding, Report, VerificationError  # noqa: F401
