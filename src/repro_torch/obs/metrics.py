"""Counters, gauges, and histograms (a copy of ``repro.obs.metrics``).

A :class:`MetricsRegistry` is process-global by default (see
``repro_torch.obs.metrics()``) but fully injectable: every instrumented call
site asks the registry accessor each time, so a test can swap in a
fresh registry and read back exactly the increments its scenario
produced.  Unlike the tracer, metrics default to **enabled** — a
counter bump is two dict ops and an add, cheap enough for every hot
path — but a disabled registry hands out shared null instruments so
the cost drops to one attribute check.

Instrument names are dotted (``plan.cache.hits``,
``fabric.probe.seconds``); :meth:`MetricsRegistry.to_prometheus`
sanitises them to underscore form for the text exposition format, and
:meth:`MetricsRegistry.snapshot` returns a plain-JSON dict for
a status dump.

Histograms keep count/sum/min/max plus log2-spaced bucket counts —
enough for latency distributions (probe sweeps, compile seconds)
without reservoir sampling.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A value that goes up and down (health state, buffer depth)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """count/sum/min/max plus log2 buckets.

    Bucket ``i`` counts observations with ``2**(i-1) < v <= 2**i`` on
    the chosen ``scale`` (default 1.0; pass ``scale=1e-6`` to bucket
    seconds with microsecond resolution).  Good enough to eyeball a
    latency distribution without a reservoir.
    """

    __slots__ = ("name", "scale", "_count", "_sum", "_min", "_max",
                 "_buckets", "_lock")

    def __init__(self, name: str, scale: float = 1.0):
        self.name = name
        self.scale = scale
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        scaled = v / self.scale
        exp = math.ceil(math.log2(scaled)) if scaled > 0 else 0
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._buckets[exp] = self._buckets.get(exp, 0) + 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count if self._count else 0.0,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": {str(k): v
                            for k, v in sorted(self._buckets.items())},
            }


class _NullInstrument:
    """Shared no-op instrument handed out by a disabled registry."""

    __slots__ = ()
    name = ""
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": None,
                "max": None, "buckets": {}}


_NULL = _NullInstrument()

Instrument = Union[Counter, Gauge, Histogram, _NullInstrument]


class MetricsRegistry:
    """Lazily-created named instruments with JSON/Prometheus snapshots."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- instrument accessors (create on first use) ------------------------
    def counter(self, name: str) -> Instrument:
        if not self.enabled:
            return _NULL
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Instrument:
        if not self.enabled:
            return _NULL
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str, scale: float = 1.0) -> Instrument:
        if not self.enabled:
            return _NULL
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name, scale=scale)
            return inst

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """All instruments as one plain-JSON dict."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(histograms.items())},
        }

    def to_prometheus(self) -> str:
        """The registry in Prometheus text exposition format."""
        snap = self.snapshot()
        lines: List[str] = []
        for name, value in snap["counters"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {_prom_num(value)}")
        for name, value in snap["gauges"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_num(value)}")
        for name, summ in snap["histograms"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            cumulative = 0
            for exp, count in sorted(
                    ((int(k), v) for k, v in summ["buckets"].items())):
                cumulative += count
                le = (2.0 ** exp) * self._hist_scale(name)
                lines.append(
                    f'{pn}_bucket{{le="{_prom_num(le)}"}} {cumulative}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {summ["count"]}')
            lines.append(f"{pn}_sum {_prom_num(summ['sum'])}")
            lines.append(f"{pn}_count {summ['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def _hist_scale(self, name: str) -> float:
        h = self._histograms.get(name)
        return h.scale if h is not None else 1.0

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch == "_" or (ch == ":" and i):
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
