"""Session health, ``healthy → degraded → halted`` (a copy of ``repro.faults.health``).

The lifecycle states of :class:`repro_torch.session.Session` (created /
attached / planned / applied / closed) say where the session is in its
*workflow*; health says how much the runtime should currently trust it:

* ``healthy`` — plans are fresh, the monitor is observing normally;
* ``degraded`` — consecutive failures crossed the retry policy's
  ``failure_threshold``, or a re-plan fell down the degradation ladder:
  the session still serves a plan (stale, hot-patched, or identity) but
  consumers were told via the ``degraded`` hook;
* ``halted`` — failures crossed ``halt_threshold``: the monitor stops
  burning probes, the session pins the identity-safe plan, and only an
  explicit :meth:`HealthTracker.reset` (a human or an orchestrator
  deciding the fabric is sane again) returns it to service.

Transitions are monotone between resets (healthy can degrade, degraded
can halt, nothing silently un-halts) and every transition is reported to
the owner via the return value so the session can fire hooks exactly
once per edge.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch import obs

__all__ = ["HEALTH_STATES", "HealthTracker"]

HEALTH_STATES = ("healthy", "degraded", "halted")


@dataclasses.dataclass
class HealthTracker:
    """Consecutive-failure counting with two thresholds (see module doc)."""

    failure_threshold: int = 3
    halt_threshold: int = 10
    state: str = "healthy"
    consecutive_failures: int = 0
    #: (state entered, reason) transition log, newest last
    transitions: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self) -> None:
        if self.state not in HEALTH_STATES:
            raise ValueError(f"unknown health state {self.state!r}; "
                             f"expected one of {HEALTH_STATES}")
        if self.halt_threshold < self.failure_threshold:
            raise ValueError(
                f"halt_threshold ({self.halt_threshold}) must be >= "
                f"failure_threshold ({self.failure_threshold})")

    # -- events ------------------------------------------------------------
    def record_failure(self, reason: str = "") -> Optional[str]:
        """Count one failure; returns the state newly entered, if any."""
        self.consecutive_failures += 1
        if self.state != "halted" and \
                self.consecutive_failures >= self.halt_threshold:
            return self._enter("halted", reason)
        if self.state == "healthy" and \
                self.consecutive_failures >= self.failure_threshold:
            return self._enter("degraded", reason)
        return None

    def record_success(self) -> Optional[str]:
        """A clean tick; degraded sessions recover, halted ones do not."""
        self.consecutive_failures = 0
        if self.state == "degraded":
            return self._enter("healthy", "recovered")
        return None

    def force_degraded(self, reason: str) -> Optional[str]:
        """Degrade regardless of counters (a ladder rung was taken)."""
        if self.state == "healthy":
            return self._enter("degraded", reason)
        return None

    def reset(self) -> None:
        """Explicit operator reset: back to healthy, counters cleared."""
        self.consecutive_failures = 0
        if self.state != "healthy":
            self._enter("healthy", "reset")

    # -- internals ---------------------------------------------------------
    def _enter(self, state: str, reason: str) -> str:
        self.state = state
        self.transitions.append((state, reason))
        # the single transition point: every health edge is one obs
        # event + the numeric gauge dashboards alert on
        obs.tracer().event("faults.health", state=state, reason=reason)
        m = obs.metrics()
        m.counter(f"faults.health.{state}").inc()
        m.gauge("faults.health.state").set(HEALTH_STATES.index(state))
        return state
