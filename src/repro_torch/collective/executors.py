"""Lowering a collective :class:`Program` to per-round permute steps.

The port's counterpart of the lowering half of
``repro.collective.executors``: :class:`PermuteStep`,
:class:`LoweredSchedule`, :class:`Lowered` and :class:`ScheduleLowering`
(the reference's ``JaxExecutor``; the class is plain numpy in both
packages).  A :class:`LoweredSchedule` is the certified artifact the
port's runners execute, on the single-card virtual mesh
(:mod:`repro_torch.kernels.schedule_runner`,
:mod:`repro_torch.kernels.overlap`: each round's partial permutations
are index gathers over the leading rank dimension) or over a process
group (:mod:`repro_torch.kernels.group_runner`: send/recv between
processes).

The pricing executors are copies of the reference's:
:class:`AnalyticExecutor` wraps the closed-form cost models of
:mod:`repro_torch.core.cost_models` (each builder declares which model
describes it), and :class:`SimExecutor` wraps the contention-aware
max-min-fair simulator (:func:`repro_torch.core.simulator.simulate_rounds`),
the offline "real cloud" oracle the plan compiler scores candidates on.
``estimate`` returns seconds for one execution of the program
(pipelining included).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.cost_models import CostModel, make_cost_model
from repro_torch.core.simulator import simulate_rounds
from repro_torch.fabric.topology import Fabric

from .ir import Program

__all__ = ["PermuteStep", "LoweredSchedule", "Lowered", "ScheduleLowering",
           "AnalyticExecutor", "SimExecutor"]


@dataclasses.dataclass(frozen=True)
class PermuteStep:
    """One ``collective-permute`` call in axis-index (position) space.

    ``links`` is a *partial permutation*: every position appears at most
    once as a source and at most once as a destination, which is
    exactly the contract of a collective permute (``jax.lax.ppermute``
    in the reference, an index gather over ranks on the virtual mesh).  ``chunks[k]`` are the logical chunk ids
    link ``k`` carries; ``op`` tags whether the receiver accumulates
    (``reduce``) or overwrites (``copy``).  ``send_mask`` /
    ``recv_mask`` are per-position participation bits — a transfer on
    link ``(s, d)`` executes only when ``send_mask[s] and
    recv_mask[d]`` (the translation validator honors exactly this
    semantics, so a mask bug is an observable lost transfer, not dead
    metadata).
    """

    links: Tuple[Tuple[int, int], ...]       # (src_pos, dst_pos) pairs
    op: str                                  # "reduce" | "copy"
    chunks: Tuple[Tuple[int, ...], ...]      # per-link chunk ids
    send_mask: Tuple[bool, ...]              # send_mask[pos]
    recv_mask: Tuple[bool, ...]              # recv_mask[pos]
    round_index: int                         # source Program round

    @property
    def n_transfers(self) -> int:
        return sum(len(c) for c in self.chunks)


@dataclasses.dataclass(frozen=True)
class LoweredSchedule:
    """The generalized lowering: per-round collective-permute steps.

    Any round-based :class:`~repro_torch.collective.ir.Program` lowers to
    this form: each IR round (a barrier of concurrent flows) becomes a
    tuple of :class:`PermuteStep`\\ s — a deterministic decomposition of
    the round's flow multigraph into partial permutations, one per
    ``(op tag, matching)`` — executed against *round-entry* state (the
    runtime stages every step's receives and applies them at the round
    barrier, mirroring the IR's semantics; see
    ``repro_torch.kernels.schedule_runner``).

    Everything speaks axis-index space: ``order[rank] = position`` is
    the program's ``local_perm`` (the solved placement), and step links
    pair positions: on the virtual mesh a step is an index gather over
    the leading rank dimension.  ``source_fingerprint`` names the exact
    Program this was lowered from;
    :func:`repro_torch.analysis.equiv.bisimulate` certifies the pair, and
    :meth:`fingerprint` identifies the artifact itself.  Schedules are
    built only by :class:`ScheduleLowering`, so every schedule a runner
    sees went through the one certified lowering path.
    """

    algorithm: str
    kind: str                                 # CollectiveOp kind
    n: int
    order: Tuple[int, ...]                    # order[rank] = position
    n_chunks: int
    chunk_bytes: float
    init: str                                 # one of ir.INITS
    postcondition: str                        # one of ir.POSTCONDITIONS
    rounds: Tuple[Tuple[PermuteStep, ...], ...]
    chunk_factor: int = 1
    source_fingerprint: str = ""

    @property
    def rank_of(self) -> Tuple[int, ...]:
        """Inverse of ``order``: rank_of[position] = logical rank."""
        inv = [0] * self.n
        for rank, pos in enumerate(self.order):
            inv[pos] = rank
        return tuple(inv)

    @property
    def n_steps(self) -> int:
        return sum(len(r) for r in self.rounds)

    @property
    def n_transfers(self) -> int:
        return sum(s.n_transfers for r in self.rounds for s in r)

    def slice_rounds(self, start: int = 0,
                     stop: Optional[int] = None) -> "LoweredSchedule":
        """Sub-schedule holding ``rounds[start:stop]``.

        The per-round execution window the overlap layer
        (:mod:`repro_torch.kernels.overlap`) interleaves compute into.  Steps
        keep their original ``round_index`` for traceability, and
        ``source_fingerprint`` still names the full program.  A partial
        window carries ``postcondition="none"`` — only the complete
        round sequence satisfies the declared contract — and a window
        with ``start > 0`` is only meaningful against explicitly seeded
        mid-stream buffers (``init`` is kept for shape metadata only).
        Slicing never edits a round: the full-range slice is the
        schedule itself, so certification transfers.
        """
        stop = len(self.rounds) if stop is None else stop
        if not (0 <= start <= stop <= len(self.rounds)):
            raise ValueError(
                f"round window [{start}, {stop}) out of range for "
                f"{len(self.rounds)} rounds")
        if start == 0 and stop == len(self.rounds):
            return self
        return dataclasses.replace(self, rounds=self.rounds[start:stop],
                                   postcondition="none")

    def split_rounds(self) -> Tuple["LoweredSchedule", ...]:
        """One single-round sub-schedule per round, in order."""
        return tuple(self.slice_rounds(i, i + 1)
                     for i in range(len(self.rounds)))

    def fingerprint(self) -> str:
        """Stable content hash of the lowered artifact."""
        payload = {
            "algorithm": self.algorithm,
            "kind": self.kind,
            "order": list(self.order),
            "n_chunks": self.n_chunks,
            "chunk_bytes": float(self.chunk_bytes),
            "init": self.init,
            "post": self.postcondition,
            "chunk_factor": self.chunk_factor,
            "rounds": [
                [(list(map(list, s.links)), s.op,
                  [list(c) for c in s.chunks],
                  [int(b) for b in s.send_mask],
                  [int(b) for b in s.recv_mask])
                 for s in rnd]
                for rnd in self.rounds
            ],
        }
        blob = json.dumps(payload, separators=(",", ":"), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Lowered:
    """A plan entry's lowering in *axis-index* (local position) space.

    ``order`` is the ring order the program's permutation induces over
    the group; ``links`` are that ring's neighbour pairs; ``shift_rounds``
    are the per-round ``(src, dst)`` pairs (all-to-all programs only; each
    round is a bijection).  ``schedule`` is the generalized per-round
    :class:`LoweredSchedule`, populated for every algorithm; the ring and
    shift views are kept as the reference's consumers read them.
    ``fingerprint`` names the source program, and ``program`` is that
    program itself (the port's addition, left out of equality and repr):
    a runner certifies ``schedule`` against it before it runs
    (:mod:`repro_torch.kernels.group_runner`).
    """

    kind: str                                    # "ring" | "shift_a2a" | "general"
    order: Tuple[int, ...]
    links: Tuple[Tuple[int, int], ...]
    shift_rounds: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    fingerprint: str = ""
    schedule: Optional[LoweredSchedule] = None
    program: Optional[Program] = dataclasses.field(
        default=None, compare=False, repr=False)


class AnalyticExecutor:
    """Prices programs with the paper's closed-form cost models.

    Construct with full-fabric node-indexed matrices: either one
    pairwise ``cost_matrix`` (paper mode — rounds rescale linearly) or
    ``lat``/``bw`` (alpha-beta mode).  Group extraction and the
    rank→local-index mapping happen here, so callers hand over programs
    whose ``perm`` speaks global node ids.
    """

    name = "analytic"

    def __init__(self, cost_matrix: Optional[np.ndarray] = None, *,
                 lat: Optional[np.ndarray] = None,
                 bw: Optional[np.ndarray] = None):
        if cost_matrix is None and lat is None:
            raise ValueError(
                "AnalyticExecutor needs a cost_matrix or lat (+ bw)")
        self.c = None if cost_matrix is None else np.asarray(
            cost_matrix, dtype=np.float64)
        self.lat = None if lat is None else np.asarray(lat, dtype=np.float64)
        self.bw = None if bw is None else np.asarray(bw, dtype=np.float64)
        self._models: Dict[tuple, CostModel] = {}

    def model_for(self, program: Program) -> CostModel:
        """The builder-declared CostModel at the program's piece size."""
        g = np.asarray(sorted(program.op.group), dtype=np.int64)
        size = program.op.size_bytes / program.chunk_factor
        kwargs = {k: v for k, v in program.kwargs.items() if k == "base"}
        key = (program.cost_model, tuple(g), float(size),
               tuple(sorted(kwargs.items())))
        model = self._models.get(key)
        if model is None:
            if self.c is not None:
                model = make_cost_model(
                    program.cost_model, cost_matrix=self.c[np.ix_(g, g)],
                    size_bytes=size, **kwargs)
            else:
                sub_bw = None if self.bw is None else self.bw[np.ix_(g, g)]
                if sub_bw is None:
                    model = make_cost_model(
                        program.cost_model,
                        cost_matrix=self.lat[np.ix_(g, g)],
                        size_bytes=size, **kwargs)
                else:
                    model = make_cost_model(
                        program.cost_model, size_bytes=size,
                        lat=self.lat[np.ix_(g, g)], bw=sub_bw, **kwargs)
            self._models[key] = model
        return model

    def estimate(self, program: Program) -> float:
        model = self.model_for(program)
        return program.chunk_factor * float(model.cost(program.local_perm))

    def lower(self, program: Program) -> Lowered:
        raise NotImplementedError(
            "AnalyticExecutor prices programs; use ScheduleLowering to lower")


class SimExecutor:
    """Prices programs on the contention-aware flow-level simulator."""

    name = "sim"

    def __init__(self, fabric: Fabric, jitter: float = 0.0,
                 seed: Optional[int] = None):
        self.fabric = fabric
        self.jitter = jitter
        self.seed = seed

    def estimate(self, program: Program) -> float:
        if self.jitter == 0.0 and program.chunk_factor > 1:
            # deterministic pipelining: the k pieces are identical, so
            # simulate one and scale instead of re-water-filling k times
            return program.chunk_factor * simulate_rounds(
                self.fabric, program.piece_flows())
        rng = np.random.default_rng(self.seed) if self.seed is not None \
            else None
        return simulate_rounds(self.fabric, program.to_flows(),
                               rng=rng, jitter=self.jitter)

    def lower(self, program: Program) -> Lowered:
        raise NotImplementedError(
            "SimExecutor prices programs; use ScheduleLowering to lower")


#: builder names with a closed-form artifact, by shape: they keep their
#: ``kind`` (and ``links``/``shift_rounds`` views), as the reference's
#: consumers read them; everything else lowers as ``kind="general"``
_RING_ALGOS = ("ring", "ring_sequential", "ring_all_gather")
_SHIFT_ALGOS = ("all_to_all",)


def _decompose_round(
    flows, lp: Tuple[int, ...], n: int, round_index: int,
) -> Tuple[PermuteStep, ...]:
    """Decompose one IR round into position-space partial permutations.

    Greedy and deterministic: flows are visited in program order and
    packed into the first open step with the same reduce/copy tag whose
    source and destination positions are both still free (the ppermute
    contract).  Builders with per-round fan-out > 1 (bcube's b-1 peer
    exchanges, the double binary tree's two-child reduces) therefore
    split into several sequential collective-permute calls; single-
    matching rounds (rings, hypercube exchanges) stay one step.  All
    steps of a round still read *round-entry* state — the runtime
    applies receives at the round barrier — so the decomposition never
    reorders a data dependency.
    """
    # each open step: (op, links, chunks, used_src, used_dst)
    open_steps: List[Tuple[str, List[Tuple[int, int]],
                           List[Tuple[int, ...]], set, set]] = []
    for f in flows:
        s, d = lp[f.src], lp[f.dst]
        for op, links, chunks, used_s, used_d in open_steps:
            if op == f.op and s not in used_s and d not in used_d:
                links.append((s, d))
                chunks.append(tuple(int(c) for c in f.chunks))
                used_s.add(s)
                used_d.add(d)
                break
        else:
            open_steps.append(
                (f.op, [(s, d)], [tuple(int(c) for c in f.chunks)],
                 {s}, {d}))
    steps = []
    for op, links, chunks, used_s, used_d in open_steps:
        steps.append(PermuteStep(
            links=tuple(links), op=op, chunks=tuple(chunks),
            send_mask=tuple(i in used_s for i in range(n)),
            recv_mask=tuple(i in used_d for i in range(n)),
            round_index=round_index))
    return tuple(steps)


class ScheduleLowering:
    """Lowers round-based programs to per-round permute schedules.

    The counterpart of the reference's ``JaxExecutor`` (its
    ``lower_schedule``): the artifact speaks *axis-index* space, position
    i within the (sorted) group; ``order`` is the program's local
    permutation — the ring order the solved rank placement induces — and
    the steps are derived from the program's rounds, so a runner
    consuming the schedule executes exactly the flows the plan was
    priced on.  Every registered algorithm lowers.
    """

    def can_lower(self, program: Program) -> bool:
        """Total for round-based programs: every flow round decomposes
        into partial permutations, so any structurally valid Program
        lowers (certification is the certifier's job, not a shape test)."""
        return bool(program.rounds) or program.n == 1

    def lower_schedule(self, program: Program) -> LoweredSchedule:
        """Program rounds → per-round permute steps.  Pure structure
        translation — no certification; callers that execute the result
        pass it through :func:`repro_torch.analysis.require_certified`."""
        lp = tuple(int(i) for i in program.local_perm)
        n = program.n
        rounds = tuple(
            _decompose_round(rnd, lp, n, r_i)
            for r_i, rnd in enumerate(program.rounds))
        return LoweredSchedule(
            algorithm=program.algorithm,
            kind=program.op.kind,
            n=n,
            order=lp,
            n_chunks=program.n_chunks,
            chunk_bytes=float(program.chunk_bytes),
            init=program.init,
            postcondition=program.postcondition,
            rounds=rounds,
            chunk_factor=program.chunk_factor,
            source_fingerprint=program.fingerprint(),
        )

    def lower(self, program: Program) -> Lowered:
        """The :class:`Lowered` artifact of ``program``: its
        :meth:`lower_schedule` plus the ring or shift view the reference's
        ``JaxExecutor.lower`` gives the same algorithm.  No certification
        here either (:meth:`repro_torch.session.Session.lower` certifies)."""
        with obs.tracer().span("collective.lower",
                               algo=program.algorithm, n=program.n):
            lp = tuple(int(i) for i in program.local_perm)
            n = program.n
            links = tuple((lp[i], lp[(i + 1) % n]) for i in range(n))
            schedule = self.lower_schedule(program)
            fp = program.fingerprint()
            if program.algorithm in _RING_ALGOS:
                obs.metrics().counter("collective.lowered.ring").inc()
                return Lowered(kind="ring", order=lp, links=links,
                               fingerprint=fp, schedule=schedule,
                               program=program)
            if program.algorithm in _SHIFT_ALGOS:
                shift_rounds = tuple(
                    tuple(sorted((lp[f.src], lp[f.dst]) for f in rnd))
                    for rnd in program.rounds)
                obs.metrics().counter("collective.lowered.shift_a2a").inc()
                return Lowered(kind="shift_a2a", order=lp, links=links,
                               shift_rounds=shift_rounds, fingerprint=fp,
                               schedule=schedule, program=program)
            obs.metrics().counter("collective.lowered.general").inc()
            return Lowered(kind="general", order=lp, links=(),
                           fingerprint=fp, schedule=schedule, program=program)
