"""repro_torch.plan — the collective plan compiler (copies of ``repro.plan``).

The manual chain this package serves::

    fabric = make_datacenter(8, nodes_per_rack=4, racks_per_agg=2, seed=0)
    probed = probe_fabric(fabric, seed=0)           # paper §IV-B probing
    plan   = PlanCompiler(fabric=fabric, seed=0).compile(
        probed, train_mix(payload_bytes), mesh_shape=(8,))
    entry  = plan.lookup("all-reduce", payload_bytes)
    reducer = reducer_from_plan(plan, payload_bytes)  # repro_torch.train

Beside the compiler: the fingerprint-keyed :class:`PlanCache` with its
:class:`DriftMonitor`, and the :class:`PlanningService` that dedups
concurrent compiles.  Most callers go through
:class:`repro_torch.session.Session`, which owns all three.
"""

from .cache import (  # noqa: F401
    DriftMonitor,
    DriftReport,
    FabricFingerprint,
    PlanCache,
    fabric_fingerprint,
)
from .compiler import (  # noqa: F401
    CollectiveRequest,
    JobMix,
    Plan,
    PlanCompiler,
    PlanEntry,
    SolveBudget,
    candidate_algorithms,
    size_bucket,
)
from .service import PlanningService  # noqa: F401
