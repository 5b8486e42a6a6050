"""Workload capture: the ``(op, bytes, group, t)`` stream of collective issues.

The recording half of ``repro.obs.capture``, copied: the serve engine
feeds :class:`WorkloadRecorder` one row per collective a decode step
would issue on a tensor-parallel mesh.  Folding a trace into phase mixes
and replaying it under a plan need the planner, which the port does not
have yet; they come with it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["OpRecord", "WorkloadRecorder", "WorkloadTrace"]


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One observed collective issue: ``(op, bytes, group, t)``."""

    op: str
    size_bytes: float
    group: Optional[Tuple[int, ...]]   # global node ids; None = all nodes
    t: float                           # seconds on the recorder clock


@dataclasses.dataclass
class WorkloadTrace:
    """An ordered capture of collective issues plus provenance meta."""

    records: List[OpRecord]
    name: str = "capture"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def duration(self) -> float:
        if not self.records:
            return 0.0
        return self.records[-1].t - self.records[0].t

    @property
    def total_bytes(self) -> float:
        return sum(r.size_bytes for r in self.records)


class WorkloadRecorder:
    """Thread-safe bounded ``(op, bytes, group, t)`` stream.

    Hooked call sites call :meth:`record` unconditionally; when
    disabled the call is one attribute check.  Timestamps come from the
    injected ``clock`` relative to the recorder's construction epoch.
    """

    def __init__(self, enabled: bool = False, buffer: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.clock = clock
        self._epoch = clock()
        self._buf: "deque[OpRecord]" = deque(maxlen=int(buffer))
        self._lock = threading.Lock()
        #: monotone count of records ever captured (survives ring wrap)
        self.captured = 0

    def record(self, op: str, size_bytes: float,
               group: Optional[Sequence[int]] = None) -> None:
        if not self.enabled:
            return
        rec = OpRecord(op=op, size_bytes=float(size_bytes),
                       group=tuple(int(x) for x in group)
                       if group is not None else None,
                       t=self.clock() - self._epoch)
        with self._lock:
            self._buf.append(rec)
            self.captured += 1

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def trace(self, name: str = "capture",
              meta: Optional[Dict[str, Any]] = None) -> WorkloadTrace:
        """Snapshot the buffer as a :class:`WorkloadTrace`."""
        with self._lock:
            records = list(self._buf)
        return WorkloadTrace(records=records, name=name, meta=dict(meta or {}))
