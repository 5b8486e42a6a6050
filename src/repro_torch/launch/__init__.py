"""Launch helpers (counterpart of ``repro.launch``): the planned mesh,
virtual or group-backed (:mod:`.mesh`), ``build_mesh`` (:mod:`.train`),
and the cells' sharded stand-ins, ``configure_sp`` and ``input_specs``
(:mod:`.specs`, imported on its own).

The reference's production meshes, dry-run, HLO analysis and serve
launcher are not ported (ROADMAP.md §1 slice 6, item 15).
"""

from .mesh import PlannedMesh, make_mesh, make_planned_mesh  # noqa: F401
from .train import apply_planned, build_mesh, parse_mesh, planning_session  # noqa: F401
