"""Deterministic fault injection for cloud fabrics (a copy of
``repro.faults.inject``).

The source paper's premise is that cloud fabrics are multi-tenant and
volatile: preemptible-VM churn, nodes joining mid-job, time-varying
tenant interference.  This module makes those scenarios first-class and
reproducible:

* :class:`FaultEvent` — one scheduled fault: a probe timeout, dropped /
  NaN probe samples, a link-degradation episode, a node preemption or
  join, or a straggler onset.  Events carry a start ``tick``, a
  ``duration`` in ticks (episodes), target ``nodes``, and a magnitude.
* :class:`FaultSchedule` — an explicit event list, or a seeded
  generator (:meth:`FaultSchedule.generate`) drawing a deterministic
  chaos timeline from per-kind rates.  Same seed, same timeline as the
  reference's: the draws come from ``np.random.default_rng(seed)`` in
  the same order, so ``bench --scenario faults`` replays the reference's
  storm.
* :class:`FaultyFabric` — duck-types :class:`repro_torch.fabric.Fabric`,
  so ``probe_fabric`` / ``sparse_probe_fabric`` / ``refresh_sparse``
  apply the active faults without touching callers: reading ``.lat`` at
  a tick with an active ``probe_timeout`` raises :class:`ProbeTimeout`
  (which the :class:`~repro_torch.session.Session` probe path retries
  under its :class:`~repro_torch.faults.RetryPolicy`), link degradations
  and stragglers inflate the matrices the probe samples, and
  ``probe_drop`` / ``probe_nan`` corrupt a seeded subset of entries.
  Membership events (preempt / join) do not mutate matrix shapes — they
  are surfaced by :meth:`FaultyFabric.advance` for the session's
  ``on_node_leave`` / ``on_node_join`` elastic path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fabric import Fabric

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultSchedule",
    "FaultyFabric",
    "ProbeTimeout",
]

#: every fault kind a schedule may carry
FAULT_KINDS = (
    "probe_timeout",   # the whole probe sweep times out (raises ProbeTimeout)
    "probe_drop",      # a fraction of probe samples are lost (entries -> +inf)
    "probe_nan",       # a fraction of probe samples are corrupted (-> NaN)
    "link_degrade",    # pairwise costs touching `nodes` inflate by `factor`
    "node_preempt",    # `nodes` leave the job (membership event)
    "node_join",       # `nodes` (re)join the job (membership event)
    "straggler",       # `nodes` slow down: all their links scale by `factor`
)

#: kinds that change membership rather than the probed matrices
MEMBERSHIP_KINDS = ("node_preempt", "node_join")


class ProbeTimeout(TimeoutError):
    """A probe sweep exceeded its deadline (injected or real)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (see :data:`FAULT_KINDS`)."""

    kind: str
    tick: int                          # first tick the fault is active
    duration: int = 1                  # ticks the fault stays active
    nodes: Tuple[int, ...] = ()        # targets (membership / degrade / straggler)
    factor: float = 1.0                # cost multiplier (degrade / straggler)
    frac: float = 0.0                  # affected entry fraction (drop / nan)

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.tick < 0 or self.duration < 1:
            raise ValueError(
                f"FaultEvent needs tick >= 0 and duration >= 1; got "
                f"tick={self.tick}, duration={self.duration}")
        object.__setattr__(self, "nodes",
                           tuple(int(x) for x in self.nodes))

    def active_at(self, tick: int) -> bool:
        return self.tick <= tick < self.tick + self.duration

    def to_dict(self) -> dict:
        return {"kind": self.kind, "tick": self.tick,
                "duration": self.duration, "nodes": list(self.nodes),
                "factor": self.factor, "frac": self.frac}

    @staticmethod
    def from_dict(d: dict) -> "FaultEvent":
        return FaultEvent(
            kind=str(d["kind"]), tick=int(d["tick"]),
            duration=int(d.get("duration", 1)),
            nodes=tuple(int(x) for x in d.get("nodes", ())),
            factor=float(d.get("factor", 1.0)),
            frac=float(d.get("frac", 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A deterministic timeline of :class:`FaultEvent`\\ s."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    horizon: int = 0                   # ticks the generator covered

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.tick, e.kind))))

    def at(self, tick: int) -> List[FaultEvent]:
        """Events active at ``tick`` (episodes included mid-flight)."""
        return [e for e in self.events if e.active_at(tick)]

    def starting_at(self, tick: int) -> List[FaultEvent]:
        """Events whose first active tick is ``tick`` (membership firing)."""
        return [e for e in self.events if e.tick == tick]

    def membership_at(self, tick: int) -> List[FaultEvent]:
        """Preempt/join events firing exactly at ``tick``."""
        return [e for e in self.starting_at(tick)
                if e.kind in MEMBERSHIP_KINDS]

    @staticmethod
    def generate(
        n: int,
        ticks: int = 32,
        seed: int = 0,
        timeout_rate: float = 0.05,
        drop_rate: float = 0.05,
        nan_rate: float = 0.05,
        degrade_rate: float = 0.1,
        preempt_frac: float = 0.0,
        preempt_tick: Optional[int] = None,
        straggler_rate: float = 0.05,
        max_degrade_factor: float = 8.0,
    ) -> "FaultSchedule":
        """Draw a deterministic chaos timeline.

        Per tick, each transient kind fires with its rate; link
        degradations and stragglers get a 2-6 tick episode over a random
        node subset with a log-uniform factor.  ``preempt_frac`` > 0
        schedules ONE preemption of that node fraction (at
        ``preempt_tick``, default mid-horizon) followed by a rejoin of
        the same nodes three quarters in — the preemptible-VM churn
        scenario the acceptance gate replays.
        """
        if n < 2 or ticks < 1:
            raise ValueError(
                f"FaultSchedule.generate needs n >= 2 and ticks >= 1; "
                f"got n={n}, ticks={ticks}")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for t in range(ticks):
            if rng.random() < timeout_rate:
                events.append(FaultEvent("probe_timeout", t))
            if rng.random() < drop_rate:
                events.append(FaultEvent(
                    "probe_drop", t, frac=float(rng.uniform(0.01, 0.1))))
            if rng.random() < nan_rate:
                events.append(FaultEvent(
                    "probe_nan", t, frac=float(rng.uniform(0.01, 0.1))))
            if rng.random() < degrade_rate:
                k = int(rng.integers(1, max(2, n // 8) + 1))
                nodes = tuple(int(x) for x in
                              rng.choice(n, size=k, replace=False))
                events.append(FaultEvent(
                    "link_degrade", t,
                    duration=int(rng.integers(2, 7)), nodes=nodes,
                    factor=float(np.exp(rng.uniform(
                        np.log(2.0), np.log(max_degrade_factor))))))
            if rng.random() < straggler_rate:
                node = int(rng.integers(0, n))
                events.append(FaultEvent(
                    "straggler", t, duration=int(rng.integers(2, 7)),
                    nodes=(node,),
                    factor=float(rng.uniform(1.5, 4.0))))
        if preempt_frac > 0.0:
            k = max(1, int(round(preempt_frac * n)))
            dead = tuple(int(x) for x in
                         rng.choice(n, size=k, replace=False))
            pt = ticks // 2 if preempt_tick is None else int(preempt_tick)
            events.append(FaultEvent("node_preempt", pt, nodes=dead))
            rejoin = pt + max(1, ticks // 4)
            if rejoin < ticks:
                events.append(FaultEvent("node_join", rejoin, nodes=dead))
        return FaultSchedule(events=tuple(events), seed=seed, horizon=ticks)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"seed": self.seed, "horizon": self.horizon,
                "events": [e.to_dict() for e in self.events]}

    @staticmethod
    def from_dict(d: dict) -> "FaultSchedule":
        return FaultSchedule(
            events=tuple(FaultEvent.from_dict(e) for e in d["events"]),
            seed=int(d.get("seed", 0)), horizon=int(d.get("horizon", 0)))


class FaultyFabric:
    """A :class:`Fabric` view with the schedule's faults applied per tick.

    Duck-types everything the probe layer reads (``n``, ``lat``, ``bw``,
    ``paths``, ``link_bw``, ``meta``, ``cost_matrix``, ``subset``), so
    it drops into ``probe_fabric(...)`` / ``sparse_probe_fabric(...)``
    / ``refresh_sparse(...)`` unchanged.  The *view* is what a probe
    would measure right now:

    * active ``link_degrade`` / ``straggler`` events inflate the latency
      rows/columns of their nodes (and deflate bandwidth);
    * active ``probe_drop`` events blank a seeded fraction of entries to
      ``+inf`` (a lost probe looks infinitely slow);
    * active ``probe_nan`` events corrupt a seeded fraction to NaN;
    * an active ``probe_timeout`` makes any matrix access raise
      :class:`ProbeTimeout` — the sweep never returns.

    Call :meth:`advance` once per monitor tick; it returns the
    membership events firing at the new tick so the harness can drive
    ``Session.on_node_leave`` / ``on_node_join``.
    """

    def __init__(self, fabric: Fabric, schedule: FaultSchedule,
                 tick: int = 0):
        self.base = fabric
        self.schedule = schedule
        self.tick = int(tick)

    # -- clock -------------------------------------------------------------
    def advance(self, ticks: int = 1) -> List[FaultEvent]:
        """Move the clock forward; returns membership events now firing."""
        if ticks < 1:
            raise ValueError(f"advance needs ticks >= 1; got {ticks}")
        fired: List[FaultEvent] = []
        for _ in range(ticks):
            self.tick += 1
            fired.extend(self.schedule.membership_at(self.tick))
        return fired

    def active(self) -> List[FaultEvent]:
        return self.schedule.at(self.tick)

    # -- Fabric duck-typing ------------------------------------------------
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def paths(self):
        return self.base.paths

    @property
    def link_bw(self) -> np.ndarray:
        return self.base.link_bw

    @property
    def meta(self) -> Dict[str, object]:
        return dict(self.base.meta, faulty=True, tick=self.tick)

    def _check_timeout(self) -> None:
        for e in self.active():
            if e.kind == "probe_timeout":
                raise ProbeTimeout(
                    f"probe sweep timed out at tick {self.tick} "
                    f"(injected by FaultSchedule seed={self.schedule.seed})")

    def _node_factors(self) -> np.ndarray:
        """Per-node cost multiplier from active degrade/straggler events."""
        f = np.ones(self.base.n)
        for e in self.active():
            if e.kind in ("link_degrade", "straggler"):
                idx = [x for x in e.nodes if 0 <= x < self.base.n]
                f[idx] *= max(e.factor, 1.0)
        return f

    def _corrupt(self, mat: np.ndarray, fill: float) -> np.ndarray:
        """Apply active drop/nan corruption for ``fill`` to ``mat``."""
        n = self.base.n
        for e in self.active():
            want = "probe_drop" if np.isinf(fill) else "probe_nan"
            if e.kind != want or e.frac <= 0.0:
                continue
            # seeded per (schedule, event, tick): the same storm corrupts
            # the same entries on every replay
            rng = np.random.default_rng(
                (self.schedule.seed, e.tick, self.tick,
                 0 if np.isinf(fill) else 1))
            k = int(e.frac * n * (n - 1))
            if k < 1:
                k = 1
            i = rng.integers(0, n, size=k)
            j = rng.integers(0, n, size=k)
            ok = i != j
            mat[i[ok], j[ok]] = fill
        return mat

    @property
    def lat(self) -> np.ndarray:
        self._check_timeout()
        f = self._node_factors()
        lat = self.base.lat * np.maximum(f[:, None], f[None, :])
        np.fill_diagonal(lat, 0.0)
        lat = self._corrupt(lat, np.inf)
        return self._corrupt(lat, np.nan)

    @property
    def bw(self) -> np.ndarray:
        self._check_timeout()
        f = self._node_factors()
        return self.base.bw / np.maximum(f[:, None], f[None, :])

    def cost_matrix(self, size_bytes: float = 0.0) -> np.ndarray:
        from repro_torch.fabric import combine_cost

        return combine_cost(self.lat, self.bw, size_bytes)

    def subset(self, nodes: Sequence[int]) -> Fabric:
        """Restriction of the *base* fabric (membership, not faults)."""
        return self.base.subset(nodes)

    def alive(self) -> List[int]:
        """Node ids alive at the current tick per the membership events."""
        alive = set(range(self.base.n))
        for e in self.schedule.events:
            if e.tick > self.tick:
                break
            if e.kind == "node_preempt":
                alive -= set(e.nodes)
            elif e.kind == "node_join":
                alive |= {x for x in e.nodes if 0 <= x < self.base.n}
        return sorted(alive)

    def __repr__(self) -> str:
        return (f"FaultyFabric(n={self.base.n}, tick={self.tick}, "
                f"active={[e.kind for e in self.active()]})")
