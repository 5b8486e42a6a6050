"""repro_torch.fabric — what the planner knows about the network fabric.

Copies of ``repro.fabric``:

* :mod:`~repro_torch.fabric.topology` — synthetic fabrics (Clos
  datacenter, TPU fleet) and the :class:`Fabric` artifact;
* :mod:`~repro_torch.fabric.probe` — dense pairwise probing, paper §IV-B;
* :mod:`~repro_torch.fabric.costs` — the one shared c_{i,j}(S) formula;
* :mod:`~repro_torch.fabric.hierarchy` — locality-tree inference from a
  probed cost matrix (agglomerative, automatic tier cut).

The sparse probe (``repro.fabric.sparse``) and the live-device probe are
not ported yet (ROADMAP.md §1 slice 4b and item 13).
"""

from .costs import combine_cost  # noqa: F401
from .hierarchy import HierarchyModel, infer_hierarchy  # noqa: F401
from .probe import ProbeResult, cost_matrix, probe_fabric  # noqa: F401
from .topology import (  # noqa: F401
    Fabric,
    make_datacenter,
    make_tpu_fleet,
    scramble,
)

__all__ = [
    "Fabric",
    "make_datacenter",
    "make_tpu_fleet",
    "scramble",
    "ProbeResult",
    "probe_fabric",
    "cost_matrix",
    "combine_cost",
    "HierarchyModel",
    "infer_hierarchy",
]
