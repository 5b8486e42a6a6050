"""Structured span/event tracing with Chrome trace-event export.

A copy of ``repro.obs.trace``: the serve engine opens its spans here.

One :class:`Tracer` instance collects timing *spans* (nested wall-clock
intervals) and instant *events* from every layer of the planning
pipeline into a bounded ring buffer.  Design constraints, in order:

* **zero-overhead when disabled** — the hot paths (plan cache lookups,
  monitor ticks, decode steps) call ``tracer.span(...)`` unconditionally;
  on a disabled tracer that returns the shared :data:`NULL_SPAN`
  singleton without allocating or reading the clock.  The contract is
  tested: a disabled tracer performs **no** allocation per call and
  records nothing;
* **injected monotonic clock** — ``Tracer(clock=...)`` takes any
  ``() -> float`` (default :func:`time.perf_counter`), so tests drive
  deterministic timestamps and replay tooling can re-stamp;
* **thread-safe** — spans may open/close on the session monitor thread,
  the planning-service pool, and the caller's thread concurrently; the
  ring buffer is lock-guarded and nesting depth is tracked per thread;
* **bounded** — the buffer is a ``deque(maxlen=...)``: a long-running
  session keeps the most recent window instead of growing without bound;
* **viewable** — :meth:`Tracer.to_chrome` emits the Chrome trace-event
  JSON format (``ph: "X"`` complete events + thread-name metadata),
  loadable directly in Perfetto / ``chrome://tracing``.

:meth:`Tracer.timer` is the one deliberate exception to the
disabled-no-clock rule: it *always* measures (the caller needs the
number — ``compile_seconds``, a CLI wall-clock line, a recovery
latency) and only *records* when tracing is enabled.  This is the
single instrumented path that replaced the ad-hoc
``time.perf_counter()`` pairs scattered through the CLI, compiler,
ladder, and trainer.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["NULL_SPAN", "Span", "TraceRecord", "Tracer"]

#: one buffered record: (phase, name, t0_s, dur_s, thread, depth, attrs)
#: phase is "X" (complete span) or "i" (instant event); times are
#: seconds on the tracer clock relative to the tracer epoch.
TraceRecord = Tuple[str, str, float, float, str, int, Optional[Dict[str, Any]]]


class _NullSpan:
    """The shared no-op span a disabled tracer hands out.

    A singleton: ``span()`` on a disabled tracer returns this exact
    object every time — no allocation, no clock read, no buffer touch.
    ``elapsed`` stays 0.0 (callers that need real timing use
    :meth:`Tracer.timer`, which always measures).
    """

    __slots__ = ()
    elapsed = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A timed interval; use as a context manager.

    ``elapsed`` (seconds) is valid after ``__exit__`` — the one number
    every former ``perf_counter`` pair now reads from here.  ``set()``
    attaches result attributes (entry counts, cache digests) that land
    in the exported event's ``args``.
    """

    __slots__ = ("_tracer", "name", "attrs", "t0", "elapsed", "_record")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]], record: bool):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.elapsed = 0.0
        self._record = record

    def set(self, **attrs: Any) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.t0 = self._tracer.clock()
        if self._record:
            self._tracer._depth_push()
        return self

    def __exit__(self, etype: Any, evalue: Any, tb: Any) -> bool:
        self.elapsed = self._tracer.clock() - self.t0
        if self._record:
            if etype is not None:
                self.set(error=f"{etype.__name__}: {evalue}")
            self._tracer._finish_span(self)
        return False


class Tracer:
    """Thread-safe bounded span/event collector (see module docstring)."""

    def __init__(self, enabled: bool = False, buffer: int = 8192,
                 clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._enabled = bool(enabled)
        self._buf: "deque[TraceRecord]" = deque(maxlen=int(buffer))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch = clock()
        #: monotone count of records ever buffered (survives ring wrap)
        self.emitted = 0

    # -- state -------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def buffer(self) -> int:
        return self._buf.maxlen or 0

    def set_enabled(self, flag: bool) -> None:
        self._enabled = bool(flag)

    def set_buffer(self, buffer: int) -> None:
        """Resize the ring buffer, keeping the newest records."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=int(buffer))

    def __len__(self) -> int:
        return len(self._buf)

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """A traced interval — :data:`NULL_SPAN` when disabled."""
        if not self._enabled:
            return NULL_SPAN
        return Span(self, name, attrs or None, record=True)

    def timer(self, name: str, **attrs: Any) -> Span:
        """An always-measuring interval (recorded only when enabled).

        The instrumented replacement for ad-hoc ``perf_counter`` pairs:
        product numbers (compile seconds, recovery ms) read
        ``timer.elapsed``, and the same interval shows up in the trace
        whenever tracing is on.
        """
        return Span(self, name, attrs or None, record=self._enabled)

    def event(self, name: str, **attrs: Any) -> None:
        """An instant event — no-op when disabled."""
        if not self._enabled:
            return
        t = self.clock() - self._epoch
        rec: TraceRecord = ("i", name, t, 0.0, threading.current_thread().name,
                            self._depth(), attrs or None)
        with self._lock:
            self._buf.append(rec)
            self.emitted += 1

    # -- nesting (per-thread depth, for display only) ----------------------
    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def _depth_push(self) -> None:
        self._tls.depth = self._depth() + 1

    def _finish_span(self, span: Span) -> None:
        depth = max(self._depth() - 1, 0)
        self._tls.depth = depth
        rec: TraceRecord = ("X", span.name, span.t0 - self._epoch,
                            span.elapsed, threading.current_thread().name,
                            depth, span.attrs)
        with self._lock:
            self._buf.append(rec)
            self.emitted += 1

    # -- reading -----------------------------------------------------------
    def records(self) -> List[TraceRecord]:
        """A snapshot copy of the buffered records, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """The buffer as a Chrome trace-event JSON object.

        Complete spans become ``ph: "X"`` events (``ts``/``dur`` in
        microseconds), instant events ``ph: "i"``; threads get stable
        integer ``tid``s plus ``thread_name`` metadata so Perfetto shows
        readable lanes.
        """
        records = self.records()
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for ph, name, t0, dur, thread, _depth, attrs in records:
            tid = tids.setdefault(thread, len(tids))
            ev: Dict[str, Any] = {
                "name": name, "ph": ph, "pid": 0, "tid": tid,
                "ts": round(t0 * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"                      # instant scope: thread
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            events.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": thread}}
            for thread, tid in tids.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)
