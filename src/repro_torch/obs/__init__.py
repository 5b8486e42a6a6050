"""repro_torch.obs — tracing, metrics and workload capture (copies of ``repro.obs``).

Three process-global but swappable singletons back the instrumented
call sites of the port:

* :func:`tracer` — a :class:`Tracer` (disabled by default; a disabled
  ``span()`` is the shared no-op singleton, a ``timer()`` always
  measures);
* :func:`metrics` — a :class:`MetricsRegistry` (enabled by default);
* :func:`recorder` — a :class:`WorkloadRecorder` (disabled by default).

Call sites fetch the accessor at call time (``obs.tracer().span``), so
tests can swap instances with the ``set_*`` functions.
"""

from __future__ import annotations

from typing import Any, Optional

from .capture import OpRecord, WorkloadRecorder, WorkloadTrace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "OpRecord",
    "Span",
    "Tracer",
    "WorkloadRecorder",
    "WorkloadTrace",
    "configure",
    "metrics",
    "recorder",
    "set_metrics",
    "set_recorder",
    "set_tracer",
    "tracer",
]

_tracer = Tracer(enabled=False)
_metrics = MetricsRegistry(enabled=True)
_recorder = WorkloadRecorder(enabled=False)


def tracer() -> Tracer:
    """The process tracer (disabled unless switched on)."""
    return _tracer


def set_tracer(t: Tracer) -> Tracer:
    """Swap the process tracer; returns the previous one."""
    global _tracer
    prev, _tracer = _tracer, t
    return prev


def metrics() -> MetricsRegistry:
    """The process metrics registry."""
    return _metrics


def set_metrics(m: MetricsRegistry) -> MetricsRegistry:
    """Swap the process registry; returns the previous one."""
    global _metrics
    prev, _metrics = _metrics, m
    return prev


def recorder() -> WorkloadRecorder:
    """The process workload recorder (disabled unless switched on)."""
    return _recorder


def set_recorder(r: WorkloadRecorder) -> WorkloadRecorder:
    """Swap the process recorder; returns the previous one."""
    global _recorder
    prev, _recorder = _recorder, r
    return prev


def configure(obs_config: Optional[Any]) -> None:
    """Apply a ``SessionConfig.obs`` section to the process singletons.

    Duck-typed (``enabled`` / ``buffer`` / ``capture`` / ``metrics``
    attributes) so ``repro_torch.obs`` stays import-independent of
    ``repro_torch.session``.  A ``None`` config is a no-op.
    """
    if obs_config is None:
        return
    _tracer.set_enabled(bool(getattr(obs_config, "enabled", False)))
    buf = int(getattr(obs_config, "buffer", 0) or 0)
    if buf and buf != _tracer.buffer:
        _tracer.set_buffer(buf)
    _metrics.enabled = bool(getattr(obs_config, "metrics", True))
    _recorder.enabled = bool(getattr(obs_config, "capture", False))
