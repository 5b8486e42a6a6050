"""repro_torch.collective — the typed collective IR and its lowering.

Copies of ``repro.collective``'s IR (:mod:`.ir`), its eight registered
builders (:mod:`.builders`), the rewrite passes (:mod:`.passes`), the
lowering to per-round permute schedules and the pricing executors
(:mod:`.executors`), all numpy.
The schedules they produce are what the port's runners execute on the
card, after :func:`repro_torch.analysis.require_certified` has proved
each one against its program.
"""

from .builders import (  # noqa: F401
    AlgorithmBuilder,
    candidates,
    compile_op,
    get_builder,
    registered_builders,
)
from .executors import (  # noqa: F401
    AnalyticExecutor,
    Lowered,
    LoweredSchedule,
    PermuteStep,
    ScheduleLowering,
    SimExecutor,
)
from .ir import (  # noqa: F401
    INITS,
    CollectiveOp,
    FlowInstr,
    Program,
    ProgramInvariantError,
    kind_from_op,
    validate,
)
from .passes import apply_permutation, chunk, fuse_rounds  # noqa: F401
