"""repro_torch.faults — fault injection and session resilience (copies of ``repro.faults``).

* :mod:`~repro_torch.faults.inject` — :class:`FaultSchedule` (a seeded,
  deterministic timeline of fault events) and :class:`FaultyFabric` (a
  duck-typed fabric wrapper that applies the schedule to any probe path
  without touching callers); ``bench --scenario faults`` replays its
  churn storm against a :class:`~repro_torch.session.Session`;
* :mod:`~repro_torch.faults.retry` — :class:`RetryPolicy` capped
  exponential backoff with seeded jitter, shared by the probe, re-plan
  and monitor paths;
* :mod:`~repro_torch.faults.health` — the ``healthy → degraded →
  halted`` session health state machine;
* :mod:`~repro_torch.faults.ladder` — the graceful-degradation ladder
  (warm-start re-solve → bottleneck hot-patch → stale plan → identity
  order) and elastic-membership plan recovery.
"""

from .health import HEALTH_STATES, HealthTracker  # noqa: F401
from .inject import (  # noqa: F401
    FAULT_KINDS,
    FaultEvent,
    FaultSchedule,
    FaultyFabric,
    ProbeTimeout,
)
from .ladder import (  # noqa: F401
    LADDER_RUNGS,
    identity_fallback,
    recover_entry,
    recover_plan,
    restrict_perm,
    warm_refine,
)
from .retry import RetryError, RetryPolicy, call_with_retries  # noqa: F401

__all__ = [
    "FAULT_KINDS",
    "HEALTH_STATES",
    "LADDER_RUNGS",
    "FaultEvent",
    "FaultSchedule",
    "FaultyFabric",
    "HealthTracker",
    "ProbeTimeout",
    "RetryError",
    "RetryPolicy",
    "call_with_retries",
    "identity_fallback",
    "recover_entry",
    "recover_plan",
    "restrict_perm",
    "warm_refine",
]
