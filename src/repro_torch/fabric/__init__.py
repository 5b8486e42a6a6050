"""repro_torch.fabric — what the planner knows about the network fabric.

Copies of ``repro.fabric``:

* :mod:`~repro_torch.fabric.topology` — synthetic fabrics (Clos
  datacenter, TPU fleet) and the :class:`Fabric` artifact;
* :mod:`~repro_torch.fabric.probe` — dense pairwise probing, paper §IV-B;
* :mod:`~repro_torch.fabric.costs` — the one shared c_{i,j}(S) formula;
* :mod:`~repro_torch.fabric.hierarchy` — locality-tree inference from a
  probed cost matrix (agglomerative, automatic tier cut);
* :mod:`~repro_torch.fabric.sparse` — budgeted O(n·log n) probing that
  recovers the hierarchy from a fraction of the dense probes.

The live-device probe (``probe_mesh_pairwise``) is not ported yet
(ROADMAP.md §1 item 13).
"""

from .costs import combine_cost  # noqa: F401
from .hierarchy import HierarchyModel, infer_hierarchy  # noqa: F401
from .probe import ProbeResult, cost_matrix, probe_fabric  # noqa: F401
from .sparse import (  # noqa: F401
    SparseProbeResult,
    refresh_sparse,
    sparse_probe_fabric,
)
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
    "SparseProbeResult",
    "sparse_probe_fabric",
    "refresh_sparse",
]
