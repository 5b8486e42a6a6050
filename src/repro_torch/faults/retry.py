"""Capped exponential backoff with deterministic jitter (a copy of
``repro.faults.retry``).

The monitor loop, the probe path, and the planning service all face the
same failure shape: a transient fault (probe timeout, noisy-neighbor
congestion episode, a racing re-attach) that resolves itself within a
few seconds — and the occasional persistent one that does not.  Before
this module each caller either crashed or spun hot on a bare
``warnings.warn``.  A :class:`RetryPolicy` gives them one shared
contract:

* **retries** — :func:`call_with_retries` re-invokes the callable up to
  ``max_retries`` times with capped exponential backoff between
  attempts, then raises :class:`RetryError` wrapping the last failure;
* **jitter** — each delay is scaled by a seeded uniform factor so a
  fleet of sessions probing the same fabric does not synchronize its
  retry storms (and tests stay deterministic);
* **health thresholds** — ``failure_threshold`` / ``halt_threshold``
  are consumed by the session health state machine
  (:mod:`repro_torch.faults.health`): consecutive monitor-tick failures past
  the first threshold degrade the session, past the second halt it.

The policy is a frozen all-scalar dataclass so it slots into
:class:`repro_torch.session.SessionConfig` as the ``retry`` section and
round-trips through dict / JSON / ``REPRO_RETRY_*`` env overrides like
every other section.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, TypeVar

import numpy as np

from repro_torch import obs

__all__ = ["RetryPolicy", "RetryError", "call_with_retries"]

T = TypeVar("T")


class RetryError(RuntimeError):
    """Every attempt failed; ``last`` is the final underlying exception."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"gave up after {attempts} attempt(s); last error: "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff + health-threshold knobs shared by probe/plan/monitor paths.

    ``delay(attempt)`` for attempt = 1, 2, ... is
    ``min(max_delay_s, base_delay_s * multiplier**(attempt-1))`` scaled
    by ``1 ± jitter`` (seeded uniform).  All fields are scalars so the
    policy doubles as the ``retry`` section of a session config.
    """

    #: re-invocations after the first failure (0 = fail immediately)
    max_retries: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    #: relative jitter amplitude in [0, 1); 0.1 = delays vary by ±10%
    jitter: float = 0.1
    #: consecutive monitor-tick failures before the session degrades
    failure_threshold: int = 3
    #: consecutive monitor-tick failures before the session halts
    halt_threshold: int = 10
    #: seed for the jitter stream (deterministic chaos tests)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(
                f"RetryPolicy.max_retries must be >= 0; got {self.max_retries}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError(
                f"RetryPolicy delays must be >= 0; got base_delay_s="
                f"{self.base_delay_s}, max_delay_s={self.max_delay_s}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"RetryPolicy.multiplier must be >= 1 (backoff never "
                f"shrinks); got {self.multiplier}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(
                f"RetryPolicy.jitter must be in [0, 1); got {self.jitter}")
        if self.failure_threshold < 1 or self.halt_threshold < 1:
            raise ValueError(
                f"RetryPolicy thresholds must be >= 1; got "
                f"failure_threshold={self.failure_threshold}, "
                f"halt_threshold={self.halt_threshold}")
        if self.halt_threshold < self.failure_threshold:
            raise ValueError(
                f"RetryPolicy.halt_threshold ({self.halt_threshold}) must "
                f"be >= failure_threshold ({self.failure_threshold}): a "
                f"session degrades before it halts")

    def delay(self, attempt: int,
              rng: Optional[np.random.Generator] = None) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        if attempt < 1:
            return 0.0
        base = min(self.max_delay_s,
                   self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter <= 0.0:
            return float(base)
        if rng is None:
            rng = np.random.default_rng(self.seed + attempt)
        return float(base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)))


def call_with_retries(
    fn: Callable[[], T],
    policy: RetryPolicy,
    sleep: Callable[[float], Any] = None,
    rng: Optional[np.random.Generator] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
) -> T:
    """Invoke ``fn`` under ``policy``; raise :class:`RetryError` at the cap.

    ``sleep(delay_s)`` defaults to :func:`time.sleep`; the session
    monitor passes its stop-event ``wait`` so a close() interrupts a
    backoff immediately.  ``on_retry(attempt, error, delay_s)`` fires
    before each backoff — the hook the session uses for telemetry.
    """
    if sleep is None:
        import time

        sleep = time.sleep
    if rng is None:
        rng = np.random.default_rng(policy.seed)
    last: Optional[BaseException] = None
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the whole point is containment
            last = e
            if attempt >= policy.max_retries:
                break
            d = policy.delay(attempt + 1, rng)
            obs.metrics().counter("faults.retry.attempts").inc()
            obs.tracer().event("faults.retry", attempt=attempt + 1,
                               delay_s=d, error=repr(e))
            if on_retry is not None:
                on_retry(attempt + 1, e, d)
            sleep(d)
    obs.metrics().counter("faults.retry.exhausted").inc()
    raise RetryError(policy.max_retries + 1, last)
