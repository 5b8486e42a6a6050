"""repro_torch.faults — session resilience (copies of ``repro.faults``).

* :mod:`~repro_torch.faults.retry` — :class:`RetryPolicy` capped
  exponential backoff with seeded jitter, shared by the probe, re-plan
  and monitor paths;
* :mod:`~repro_torch.faults.health` — the ``healthy → degraded →
  halted`` session health state machine;
* :mod:`~repro_torch.faults.ladder` — the graceful-degradation ladder
  (warm-start re-solve → bottleneck hot-patch → stale plan → identity
  order) and elastic-membership plan recovery.

The reference's fault injection (``repro.faults.inject``: ``FaultSchedule``,
``FaultyFabric``) serves its churn benchmark, which is not ported
(ROADMAP.md §1 slice 6).
"""

from .health import HEALTH_STATES, HealthTracker  # noqa: F401
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
    "HEALTH_STATES",
    "LADDER_RUNGS",
    "HealthTracker",
    "RetryError",
    "RetryPolicy",
    "call_with_retries",
    "identity_fallback",
    "recover_entry",
    "recover_plan",
    "restrict_perm",
    "warm_refine",
]
