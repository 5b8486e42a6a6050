"""repro_torch.analysis — the certifier the port's runners rely on.

Copies of the parts of ``repro.analysis`` that the training path needs:

* :mod:`~repro_torch.analysis.equiv` — translation validation: proves a
  :class:`~repro_torch.collective.executors.LoweredSchedule` bisimilar
  to its source Program; :func:`require_certified` is the gate every
  schedule passes before a runner touches it, :func:`certify_stages`
  the stage-by-stage proof of ``analyze --equiv``;
* :mod:`~repro_torch.analysis.deps` — the dependency pass that
  :func:`~repro_torch.collective.passes.fuse_rounds` re-checks after
  fusing;
* :mod:`~repro_torch.analysis.report` — findings, reports and
  :class:`VerificationError`;
* the plan compiler's static gate: :mod:`~repro_torch.analysis.liveness`,
  :mod:`~repro_torch.analysis.bounds`,
  :mod:`~repro_torch.analysis.contention` and the pass driver
  :mod:`~repro_torch.analysis.verify` (``verify_program``,
  ``require_valid``, ``GATE_PASSES``).

* :mod:`~repro_torch.analysis.lint` — the repo's AST-level lint gate
  (``analyze --lint``), the reference's seven rules.

The mutant screen (``repro.analysis.mutate``) stays in the reference: the
port's tests draw its mutants from there.
"""

from .bounds import analyze_bounds, bandwidth_lower_bound  # noqa: F401
from .contention import analyze_contention, link_loads  # noqa: F401
from .deps import analyze_dependencies, require_acyclic  # noqa: F401
from .equiv import (  # noqa: F401
    analyze_equiv,
    bisimulate,
    certify_stages,
    require_certified,
    symbolic_execute,
)
from .liveness import analyze_liveness  # noqa: F401
from .report import SEVERITIES, Finding, Report, VerificationError  # noqa: F401
from .verify import (  # noqa: F401
    GATE_PASSES,
    PASSES,
    PassContext,
    require_valid,
    verify_program,
)
