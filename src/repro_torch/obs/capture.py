"""Workload trace capture → phase-windowed JobMixes → replay (a copy of
``repro.obs.capture``).

Real ML jobs do not issue one stationary collective mix: decode steps
are dominated by small latency-bound all-gathers, MoE phases by large
all-to-alls, optimizer steps by huge all-reduces.  A plan compiled for a
single *declared* mix therefore prices some phases with entries tuned
for the wrong size band.

* :class:`WorkloadRecorder` — a thread-safe, bounded stream of
  :class:`OpRecord` ``(op, size_bytes, group, t)`` rows, fed by the
  port's serve engine (per decode step), the reducer (per gradient
  bucket) and ``moe_a2a`` (per dispatch).  Like the tracer it has an
  injected clock and a zero-work disabled mode;
* :class:`WorkloadTrace` — a capture with its provenance; its JSON
  (:meth:`WorkloadTrace.save` / :meth:`WorkloadTrace.load`) is the
  reference's, so a trace written by either package loads in the other;
* :func:`fold` — fold a captured trace into time-windowed
  phase-specific :class:`repro_torch.plan.JobMix` objects.  Records are
  aggregated per ``(op, size-octave, group)`` cell with a count-weighted
  geometric mean size, mirroring :meth:`PlanCompiler.compile`'s own cell
  merge, so a captured stationary workload folds to a mix whose
  ``key()`` equals the declared mix it came from;
* :func:`replay` — price a captured trace under a compiled plan by
  rebuilding each entry's analytic cost model *at the record's actual
  payload* and evaluating the entry's rank permutation.  Replaying the
  same trace under (a) the single declared-mix plan and (b) per-window
  plans compiled from :func:`fold` output is ``trace replay`` and the
  ``bench --scenario obs`` comparison.

``repro_torch.obs`` must not import ``repro_torch.plan`` at module level
(plan code itself is instrumented through ``repro_torch.obs``); the
fold/replay helpers import it lazily inside the call.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "OpRecord",
    "PhaseWindow",
    "WorkloadRecorder",
    "WorkloadTrace",
    "declared_mix",
    "fold",
    "replay",
    "synthetic_bursty_trace",
]


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One observed collective issue: ``(op, bytes, group, t)``."""

    op: str
    size_bytes: float
    group: Optional[Tuple[int, ...]]   # global node ids; None = all nodes
    t: float                           # seconds on the recorder clock

    def to_row(self) -> list:
        return [self.op, self.size_bytes,
                list(self.group) if self.group is not None else None, self.t]

    @staticmethod
    def from_row(row: Sequence[Any]) -> "OpRecord":
        op, size, group, t = row
        return OpRecord(op=str(op), size_bytes=float(size),
                        group=tuple(int(x) for x in group)
                        if group is not None else None,
                        t=float(t))


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

    # -- serialization (round-trip tested) --------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "name": self.name,
            "meta": self.meta,
            "records": [r.to_row() for r in self.records],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "WorkloadTrace":
        d = json.loads(s)
        return WorkloadTrace(
            records=[OpRecord.from_row(r) for r in d["records"]],
            name=d.get("name", "capture"),
            meta=dict(d.get("meta", {})),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "WorkloadTrace":
        with open(path) as f:
            return WorkloadTrace.from_json(f.read())


class WorkloadRecorder:
    """Thread-safe bounded ``(op, bytes, group, t)`` stream.

    Hooked call sites call :meth:`record` unconditionally; when
    disabled the call is one attribute check.  Timestamps come from the
    injected ``clock`` relative to the recorder's construction epoch so
    traces are self-relative and deterministic under a fake clock.
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


@dataclasses.dataclass(frozen=True)
class PhaseWindow:
    """One folded time window: ``[t0, t1)`` and the mix observed in it."""

    t0: float
    t1: float
    mix: "Any"          # repro_torch.plan.JobMix (lazy import; see module doc)
    n_records: int


def fold(trace: WorkloadTrace, window_s: float = 0.0,
         steps_per_window: float = 1.0) -> List[PhaseWindow]:
    """Fold a trace into per-window :class:`JobMix`es.

    ``window_s == 0`` folds the whole trace into one window (one mix).
    Within a window, records are merged per ``(op, size-octave, group)``
    cell: the cell's request carries the geometric-mean payload (which
    stays inside the octave, so the folded mix's :meth:`JobMix.key`
    matches a declared mix with the same cells) and ``count`` =
    records-in-cell / ``steps_per_window`` (calls per step, matching
    how declared mixes count).
    """
    from repro_torch.plan import CollectiveRequest, JobMix, size_bucket

    if not trace.records:
        return []
    t_lo = trace.records[0].t
    t_hi = trace.records[-1].t
    if window_s <= 0:
        window_s = max(t_hi - t_lo, 1e-9) + 1e-9   # one window spans all

    windows: Dict[int, Dict[Tuple[str, int, Optional[Tuple[int, ...]]],
                            List[OpRecord]]] = {}
    for rec in trace.records:
        w = int((rec.t - t_lo) / window_s)
        cell = (rec.op, size_bucket(rec.size_bytes), rec.group)
        windows.setdefault(w, {}).setdefault(cell, []).append(rec)

    out: List[PhaseWindow] = []
    for w, cells in sorted(windows.items()):
        reqs = []
        n_rec = 0
        for (op, _bucket, group), recs in sorted(
                cells.items(),
                key=lambda kv: (kv[0][0], kv[0][1], kv[0][2] or ())):
            sizes = np.asarray([r.size_bytes for r in recs], dtype=np.float64)
            geo = float(np.exp(np.mean(np.log(np.maximum(sizes, 1.0)))))
            reqs.append(CollectiveRequest(
                op=op, size_bytes=geo,
                count=len(recs) / max(steps_per_window, 1e-9),
                group=group))
            n_rec += len(recs)
        out.append(PhaseWindow(
            t0=t_lo + w * window_s, t1=t_lo + (w + 1) * window_s,
            mix=JobMix(requests=tuple(reqs),
                       name=f"{trace.name}.w{w}"),
            n_records=n_rec))
    return out


def declared_mix(trace: WorkloadTrace, name: str = "declared") -> "Any":
    """The stationary mix an operator would declare *without* capture.

    One request per op, all at the trace's single overall geometric-mean
    payload — the "pick one representative size" compromise a config
    file encodes.  This is the baseline :func:`replay` compares
    phase-windowed plans against: its entries are solved at a size no
    phase actually issues, so bursty traces price badly under it.
    """
    from repro_torch.plan import CollectiveRequest, JobMix

    if not trace.records:
        raise ValueError("declared_mix needs a non-empty trace")
    sizes = np.asarray([r.size_bytes for r in trace.records],
                       dtype=np.float64)
    geo = float(np.exp(np.mean(np.log(np.maximum(sizes, 1.0)))))
    counts: Dict[Tuple[str, Optional[Tuple[int, ...]]], int] = {}
    for r in trace.records:
        counts[(r.op, r.group)] = counts.get((r.op, r.group), 0) + 1
    reqs = tuple(
        CollectiveRequest(op=op, size_bytes=geo, count=float(c), group=group)
        for (op, group), c in sorted(
            counts.items(), key=lambda kv: (kv[0][0], kv[0][1] or ())))
    return JobMix(requests=reqs, name=name)


def _entry_cost_at(entry, size_bytes: float, lat: np.ndarray,
                   bw: Optional[np.ndarray]) -> float:
    """Price one plan entry's (algo, perm) at an arbitrary payload."""
    from repro_torch.collective import get_builder
    from repro_torch.core.cost_models import make_cost_model

    g = np.asarray(entry.group, dtype=np.int64)
    sub_lat = lat[np.ix_(g, g)]
    sub_bw = bw[np.ix_(g, g)] if bw is not None else None
    m_algo = get_builder(entry.algo).cost_model
    kwargs = {"base": entry.algo_kwargs["base"]} \
        if "base" in entry.algo_kwargs else {}
    if sub_bw is not None:
        model = make_cost_model(m_algo, size_bytes=size_bytes,
                                lat=sub_lat, bw=sub_bw, **kwargs)
    else:
        model = make_cost_model(m_algo, cost_matrix=sub_lat,
                                size_bytes=size_bytes, **kwargs)
    return float(model.cost(entry.local_perm))


def replay(trace: WorkloadTrace, plan, lat: np.ndarray,
           bw: Optional[np.ndarray] = None,
           windows: Optional[Sequence[Tuple[PhaseWindow, Any]]] = None,
           ) -> Dict[str, Any]:
    """Price a captured trace under a compiled plan (or per-window plans).

    Each record is looked up in the governing plan (``plan``, or the
    plan of the window containing ``record.t`` when ``windows`` =
    ``[(PhaseWindow, Plan), ...]`` is given, falling back to ``plan``
    between windows) and priced by rebuilding the winning entry's
    analytic cost model **at the record's actual payload** — so a plan
    whose entries were optimized for the wrong size band pays for it.
    Records whose (op, group) have no entry in the governing plan are
    skipped and counted in ``unplanned``.
    """
    total = 0.0
    unplanned = 0
    per_op: Dict[str, float] = {}
    for rec in trace.records:
        governing = plan
        if windows:
            for win, wplan in windows:
                if win.t0 <= rec.t < win.t1:
                    governing = wplan
                    break
        entry = governing.lookup(rec.op, rec.size_bytes, rec.group)
        if entry is None:
            unplanned += 1
            continue
        c = _entry_cost_at(entry, rec.size_bytes, lat, bw)
        total += c
        per_op[rec.op] = per_op.get(rec.op, 0.0) + c
    return {
        "trace": trace.name,
        "records": len(trace.records),
        "unplanned": unplanned,
        "total_seconds": total,
        "per_op_seconds": dict(sorted(per_op.items())),
    }


def synthetic_bursty_trace(n: int, *, steps: int = 6,
                           step_period: float = 1.0,
                           small_bytes: float = 64 * 1024,
                           large_bytes: float = 256 * 1024 * 1024,
                           small_per_step: int = 12,
                           large_per_step: int = 2,
                           seed: int = 0,
                           name: str = "bursty") -> WorkloadTrace:
    """A phase-alternating trace: latency-bound decode-like bursts of
    small all-gathers interleaved with bandwidth-bound optimizer-like
    phases of huge all-reduces — the regime where one stationary plan
    must compromise between size bands but per-phase plans need not.
    """
    rng = np.random.default_rng(seed)
    records: List[OpRecord] = []
    t = 0.0
    for step in range(steps):
        if step % 2 == 0:       # decode-like phase: many small ops
            for _ in range(small_per_step):
                size = small_bytes * float(rng.uniform(0.8, 1.25))
                records.append(OpRecord("all-gather", size, None, t))
                t += step_period / (small_per_step + 1)
        else:                   # optimizer-like phase: few huge ops
            for _ in range(large_per_step):
                size = large_bytes * float(rng.uniform(0.8, 1.25))
                records.append(OpRecord("all-reduce", size, None, t))
                t += step_period / (large_per_step + 1)
        t = (step + 1) * step_period
    return WorkloadTrace(records=records, name=name,
                         meta={"n": n, "steps": steps, "seed": seed,
                               "synthetic": True})
