"""The typed collective IR (a copy of ``repro.collective.ir``).

A collective is specified as a :class:`CollectiveOp` (what to compute)
and compiled by a registered builder (:mod:`repro_torch.collective.builders`)
into a :class:`Program` (how to compute it): rounds of
:class:`FlowInstr`\\ s carrying explicit reduce/copy semantics and chunk
metadata, plus the rank→node mapping as *data* — the permutation is a
rewrite pass (:func:`repro_torch.collective.passes.apply_permutation`), not a
parameter threaded through every builder.

Design rules:

* **Rank space.** ``FlowInstr`` endpoints are logical ranks
  ``0..n-1``; ``Program.perm[rank]`` is the global node id placed at
  that rank.  ``to_flows()`` materializes node-space legacy
  :class:`repro_torch.core.schedule.Flow` rounds for the simulator.
* **Chunk metadata.** Each program declares its logical data chunks
  (``n_chunks`` pieces of ``chunk_bytes`` each, initial placement
  ``init``) and every flow names the chunk ids it carries — enough for
  :func:`validate` to *interpret* the program and prove the
  postcondition (every rank ends holding the reduced/gathered result).
* **Programs are immutable.** Passes return new programs; the builder
  output is shared and never mutated.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from repro_torch.core.schedule import Flow

__all__ = [
    "KINDS",
    "INITS",
    "POSTCONDITIONS",
    "CollectiveOp",
    "FlowInstr",
    "Program",
    "ProgramInvariantError",
    "kind_from_op",
    "op_from_kind",
    "validate",
]

#: collective kinds the IR can express.  ``reduce_scatter`` is a
#: first-class kind (the plan compiler prices it with the all-gather
#: builders, which emit the mirrored reduce program for it).
KINDS = ("allreduce", "all_gather", "reduce_scatter", "all_to_all")

#: initial chunk placement models understood by :func:`validate`:
#: ``replicated`` — every rank holds every chunk (its own contribution);
#: ``sharded`` — rank r holds chunk r (complete);
#: ``addressed`` — rank s holds chunks s*n+d addressed to each rank d.
INITS = ("replicated", "sharded", "addressed")

#: program postconditions :func:`validate` can prove:
#: ``allreduce`` — every rank holds every chunk reduced over all ranks;
#: ``all_gather`` — every rank holds every chunk;
#: ``reduce_scatter`` — rank r holds chunk r reduced over all ranks;
#: ``all_to_all`` — rank d holds chunk s*n+d from every source s;
#: ``reduce`` — some rank holds every chunk reduced over all ranks
#: (rooted reduce; the naive sequential ring's broadcast lap reuses the
#: same hop sequence as its reduce lap by design — see the builder);
#: ``none`` — structural checks only.
POSTCONDITIONS = ("allreduce", "all_gather", "reduce_scatter",
                  "all_to_all", "reduce", "none")

#: plan-compiler op string <-> IR kind
_OP_TO_KIND = {
    "all-reduce": "allreduce",
    "all-gather": "all_gather",
    "reduce-scatter": "reduce_scatter",
    "all-to-all": "all_to_all",
}
_KIND_TO_OP = {v: k for k, v in _OP_TO_KIND.items()}


def kind_from_op(op: str) -> str:
    """Map a plan-compiler op string (``all-reduce``) to an IR kind."""
    try:
        return _OP_TO_KIND[op]
    except KeyError:
        raise ValueError(
            f"unknown collective op {op!r}; expected one of "
            f"{tuple(_OP_TO_KIND)}") from None


def op_from_kind(kind: str) -> str:
    """Map an IR kind (``allreduce``) back to the plan op string."""
    try:
        return _KIND_TO_OP[kind]
    except KeyError:
        raise ValueError(
            f"unknown collective kind {kind!r}; expected one of {KINDS}"
        ) from None


class ProgramInvariantError(AssertionError):
    """A :class:`Program` violated a structural or semantic invariant."""


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """What to compute: the backend-agnostic collective specification."""

    kind: str                     # one of KINDS
    size_bytes: float             # total payload (gathered size for AG)
    group: Tuple[int, ...]        # participating global node ids
    chunks: int = 1               # requested pipelining factor

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        object.__setattr__(self, "group", tuple(int(g) for g in self.group))
        if len(set(self.group)) != len(self.group) or not self.group:
            raise ValueError(f"group must be non-empty unique node ids, "
                             f"got {self.group}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")

    @property
    def n(self) -> int:
        return len(self.group)


@dataclasses.dataclass(frozen=True)
class FlowInstr:
    """One typed point-to-point transfer (rank space)."""

    src: int                      # logical rank
    dst: int
    size: float                   # bytes
    op: str = "copy"              # "reduce" | "copy"
    chunks: Tuple[int, ...] = ()  # logical chunk ids carried


@dataclasses.dataclass(frozen=True)
class Program:
    """How to compute it: rounds of typed flows + chunk semantics.

    Rounds are barriers (flows within a round are concurrent and read
    the round-entry state), matching the simulator's and the cost
    models' conservative execution model.
    """

    op: CollectiveOp
    algorithm: str                          # registered builder name
    algo_kwargs: Tuple[Tuple[str, int], ...]  # sorted builder kwargs
    rounds: Tuple[Tuple[FlowInstr, ...], ...]
    perm: Tuple[int, ...]                   # perm[rank] = global node id
    n_chunks: int                           # logical data chunks
    chunk_bytes: float                      # bytes per logical chunk
    init: str                               # one of INITS
    postcondition: str                      # one of POSTCONDITIONS
    cost_model: str                         # analytic CostModel name
    chunk_factor: int = 1                   # serialized pipeline pieces

    # -- basic views ------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.perm)

    @property
    def n_rounds(self) -> int:
        """Rounds actually executed (pipelining repeats the base body)."""
        return len(self.rounds) * self.chunk_factor

    @property
    def total_bytes(self) -> float:
        """Wire bytes for one full execution (pipelining-invariant)."""
        return sum(f.size for rnd in self.rounds for f in rnd)

    @property
    def kwargs(self) -> Dict[str, int]:
        return dict(self.algo_kwargs)

    @property
    def local_perm(self) -> np.ndarray:
        """perm as positions within sorted(group) (rank -> index)."""
        pos = {node: i for i, node in enumerate(sorted(self.op.group))}
        return np.asarray([pos[node] for node in self.perm], dtype=np.int64)

    def replace(self, **kw) -> "Program":
        return dataclasses.replace(self, **kw)

    # -- lowering to the legacy flow representation -----------------------
    def piece_flows(self) -> List[List[Flow]]:
        """Node-space flow rounds for ONE pipeline piece (payload/k)."""
        scale = 1.0 / self.chunk_factor
        return [
            [Flow(self.perm[f.src], self.perm[f.dst], f.size * scale)
             for f in rnd]
            for rnd in self.rounds
        ]

    def to_flows(self) -> List[List[Flow]]:
        """Node-space ``List[List[Flow]]`` rounds for the simulator.

        A ``chunk_factor`` of k repeats the body k times at 1/k payload
        — the serialized-pipelining model the plan compiler scores.
        """
        body = self.piece_flows()
        if self.chunk_factor == 1:
            return body
        return [list(rnd) for _ in range(self.chunk_factor) for rnd in body]

    # -- identity ---------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable content hash of the program (schedule + placement)."""
        payload = {
            "kind": self.op.kind,
            "size_bytes": float(self.op.size_bytes),
            "group": list(self.op.group),
            "algorithm": self.algorithm,
            "algo_kwargs": [list(kv) for kv in self.algo_kwargs],
            "perm": list(self.perm),
            "chunk_factor": self.chunk_factor,
            "rounds": [[(f.src, f.dst, f.size, f.op) for f in rnd]
                       for rnd in self.rounds],
        }
        blob = json.dumps(payload, separators=(",", ":"), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# validation: structural invariants + abstract interpretation
# ---------------------------------------------------------------------------

def _initial_state(
    program: Program,
) -> Dict[int, Dict[int, FrozenSet[int]]]:
    n = program.n
    full = frozenset(range(n))
    if program.init == "replicated":
        return {r: {c: frozenset((r,)) for c in range(program.n_chunks)}
                for r in range(n)}
    if program.init == "sharded":
        return {r: {r: full} for r in range(n)}
    if program.init == "addressed":
        return {s: {s * n + d: frozenset((s,)) for d in range(n)}
                for s in range(n)}
    raise ValueError(f"unknown init {program.init!r}; "
                     f"expected one of {INITS}")


def _check_postcondition(program: Program,
                         state: Dict[int, Dict[int, FrozenSet[int]]]) -> None:
    n = program.n
    full = frozenset(range(n))
    post = program.postcondition

    def held_full(rank: int, chunk: int) -> bool:
        return state[rank].get(chunk) == full

    if post == "none":
        return
    if post == "allreduce":
        bad = [(r, c) for r in range(n) for c in range(program.n_chunks)
               if not held_full(r, c)]
        if bad:
            raise ProgramInvariantError(
                f"{program.algorithm}: allreduce incomplete — rank/chunk "
                f"pairs missing full reduction: {bad[:4]}...")
    elif post == "reduce_scatter":
        bad = [r for r in range(n) if not held_full(r, r)]
        if bad:
            raise ProgramInvariantError(
                f"{program.algorithm}: reduce-scatter incomplete — ranks "
                f"{bad} do not hold their own chunk fully reduced")
    elif post == "all_gather":
        bad = [(r, c) for r in range(n) for c in range(program.n_chunks)
               if c not in state[r]]
        if bad:
            raise ProgramInvariantError(
                f"{program.algorithm}: all-gather incomplete — missing "
                f"rank/chunk pairs: {bad[:4]}...")
    elif post == "all_to_all":
        bad = [(s, d) for s in range(n) for d in range(n)
               if s * n + d not in state[d]]
        if bad:
            raise ProgramInvariantError(
                f"{program.algorithm}: all-to-all incomplete — undelivered "
                f"(src, dst) pairs: {bad[:4]}...")
    elif post == "reduce":
        if not any(all(held_full(r, c) for c in range(program.n_chunks))
                   for r in range(n)):
            raise ProgramInvariantError(
                f"{program.algorithm}: rooted reduce incomplete — no rank "
                f"holds every chunk fully reduced")
    else:
        raise ValueError(f"unknown postcondition {post!r}; "
                         f"expected one of {POSTCONDITIONS}")


def validate(program: Program, semantics: bool = True) -> None:
    """Check structural invariants and (optionally) the postcondition.

    Structural: endpoints are in-range ranks, no self-flows, payloads
    positive and finite, and every flow's bytes equal its chunk count
    times the program's declared ``chunk_bytes`` (byte conservation —
    no flow moves data its chunk metadata doesn't account for).

    Semantic: abstract interpretation over per-rank chunk→contributor
    sets; rounds are barriers (senders read round-entry state); the
    declared postcondition must hold at program end.

    Raises :class:`ProgramInvariantError` on violation.
    """
    n = program.n
    if sorted(program.perm) != sorted(program.op.group):
        raise ProgramInvariantError(
            f"{program.algorithm}: perm {program.perm} is not a "
            f"permutation of group {program.op.group}")
    if program.n_chunks < 1 or program.chunk_bytes < 0:
        raise ProgramInvariantError(
            f"{program.algorithm}: bad chunk metadata "
            f"(n_chunks={program.n_chunks}, chunk_bytes={program.chunk_bytes})")
    for r_i, rnd in enumerate(program.rounds):
        for f in rnd:
            if not (0 <= f.src < n and 0 <= f.dst < n):
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: endpoint out of "
                    f"range in {f}")
            if f.src == f.dst and n > 1:
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: self-flow {f}")
            if not np.isfinite(f.size) or f.size <= 0:
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: non-positive "
                    f"payload in {f}")
            if f.op not in ("reduce", "copy"):
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: unknown flow op "
                    f"{f.op!r}")
            if not f.chunks:
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: flow {f} carries "
                    f"no chunks")
            expect = len(f.chunks) * program.chunk_bytes
            if program.chunk_bytes and abs(f.size - expect) > 1e-9 * max(
                    expect, 1.0):
                raise ProgramInvariantError(
                    f"{program.algorithm} round {r_i}: flow bytes "
                    f"{f.size} != {len(f.chunks)} chunks x "
                    f"{program.chunk_bytes} bytes")

    if not semantics:
        return
    state = _initial_state(program)
    for rnd in program.rounds:
        # barrier semantics: all sends in a round read round-entry state
        updates: List[Tuple[str, int, int, FrozenSet[int]]] = []
        for f in rnd:
            src_chunks = state[f.src]
            for c in f.chunks:
                if c not in src_chunks:
                    raise ProgramInvariantError(
                        f"{program.algorithm}: rank {f.src} sends chunk "
                        f"{c} it does not hold")
                updates.append((f.op, f.dst, c, src_chunks[c]))
        for fop, dst, c, contrib in updates:
            if fop == "reduce":
                # accumulate into the destination's partial
                state[dst][c] = state[dst].get(c, frozenset()) | contrib
            else:
                # a copy OVERWRITES the destination buffer: the receiver
                # keeps exactly the sender's contributions, so a builder
                # that emits "copy" where a reduction is required cannot
                # validate complete (the typing exists to catch that)
                state[dst][c] = contrib
    _check_postcondition(program, state)
