"""repro_torch.session — the Session facade (a port of ``repro.session``).

Entry point for the whole planning pipeline::

    from repro_torch import Session, SessionConfig

    with Session(SessionConfig.from_dict({
            "fabric": {"kind": "datacenter", "nodes": 8},
            "mesh": {"shape": "8"}})) as s:
        applied = s.apply(device="cuda")   # probe -> plan -> apply, lazily
        print(applied.summary())

It owns the fabric probe, the planning service and plan cache, the drift
monitor and the degradation ladder; :func:`repro_torch.train.reducer_from_plan`
(or :meth:`Session.overlap_step`) turns its plan into the certified
gradient all-reduce the train step runs.
"""

from .config import (  # noqa: F401
    CacheConfig,
    DriftConfig,
    FabricConfig,
    MeshConfig,
    ObsConfig,
    OverlapConfig,
    ProbeConfig,
    RetryPolicy,
    SessionConfig,
    SolverConfig,
)
from .mixes import default_mix, serve_mix, train_mix  # noqa: F401
from .session import EVENTS, AppliedPlan, Session, SessionError  # noqa: F401
