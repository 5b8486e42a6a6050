"""Liveness / redundancy analysis: dead chunks and duplicate transfers.

Extends ``ir.validate``'s abstract chunk interpretation with
*provenance*: every per-(rank, chunk) state entry carries, besides its
contributor set, the set of instructions that transitively built it.
Slicing backwards from the entries the declared postcondition reads
yields the live set; everything else moved bytes that never reach the
result:

* **DEAD_TRANSFER** (warning) — an instruction outside the backward
  slice of the postcondition: it delivered data no required entry ever
  incorporates.  A duplicated or vestigial round shows up here.
* **DUPLICATE_DELIVERY** (warning) — two flows deliver the same chunk
  with identical contributor sets to the same rank in one round.
* **DUPLICATE_ROUND** (warning) — two *adjacent* rounds are identical;
  no correct builder emits the same barrier twice in a row (the naive
  sequential ring's two laps are identical as a sequence but never
  adjacent).
* **NO_EFFECT_TRANSFER** (info) — a reduce that adds no new
  contributors or a copy that rewrites an identical entry.  Info, not
  warning: the naive sequential ring's second lap re-walks its hop
  sequence by design (see ``_ring_sequential_allreduce``), so a
  no-effect transfer can still be load-bearing for the *typed* proof.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

from repro_torch.collective.ir import Program, _initial_state

from .report import Finding, finding

__all__ = ["analyze_liveness"]

PASS = "liveness"

#: state entry: (contributor ranks, provenance instruction ids)
Entry = Tuple[FrozenSet[int], FrozenSet[int]]


def _required_entries(program: Program,
                      state: Dict[int, Dict[int, Entry]]) -> Set[Tuple[int, int]]:
    """(rank, chunk) entries the declared postcondition reads."""
    n = program.n
    post = program.postcondition
    if post == "allreduce" or post == "all_gather":
        return {(r, c) for r in range(n) for c in range(program.n_chunks)}
    if post == "reduce_scatter":
        return {(r, r) for r in range(n)}
    if post == "all_to_all":
        return {(d, s * n + d) for s in range(n) for d in range(n)}
    if post == "reduce":
        # rooted reduce: the witness is any rank holding every chunk
        # fully reduced — slice from the first such rank
        full = frozenset(range(n))
        for r in range(n):
            if all(state[r].get(c, (frozenset(), None))[0] == full
                   for c in range(program.n_chunks)):
                return {(r, c) for c in range(program.n_chunks)}
        # invalid program (validate flags it); keep every entry live so
        # liveness does not pile misleading findings on top
        return {(r, c) for r in range(n) for c in state[r]}
    # "none": no spec to slice against
    return {(r, c) for r in range(n) for c in state[r]}


def analyze_liveness(
    program: Program,
) -> Tuple[List[Finding], Dict[str, object]]:
    findings: List[Finding] = []
    n = program.n
    # contributor sets start as ir.validate's initial state; provenance
    # starts empty (initial placement has no producing instruction)
    state: Dict[int, Dict[int, Entry]] = {
        r: {c: (contribs, frozenset()) for c, contribs in chunks.items()}
        for r, chunks in _initial_state(program).items()
    }

    instr_id = 0
    n_no_effect = 0
    all_ids: Set[int] = set()
    for r_i, rnd in enumerate(program.rounds):
        if r_i + 1 < len(program.rounds) and rnd == program.rounds[r_i + 1]:
            findings.append(finding(
                PASS, "DUPLICATE_ROUND", "warning",
                f"rounds {r_i} and {r_i + 1} are identical — the same "
                f"barrier executed twice in a row moves "
                f"{sum(f.size for f in rnd):.0f} redundant bytes",
                round=r_i))
        # barrier: collect deliveries against round-entry state
        updates: List[Tuple[str, int, int, Entry]] = []
        arrivals: Dict[Tuple[int, int], List[Tuple[FrozenSet[int], int]]] = {}
        for f in rnd:
            all_ids.add(instr_id)
            for c in f.chunks:
                entry = state[f.src].get(c)
                if entry is None:
                    # unheld send: deps/validate own this error; skip so
                    # liveness keeps analyzing the rest of the program
                    continue
                contribs, prov = entry
                updates.append((f.op, f.dst, c,
                                (contribs, prov | {instr_id})))
                arrivals.setdefault((f.dst, c), []).append(
                    (contribs, instr_id))
            instr_id += 1
        for (dst, c), deliveries in arrivals.items():
            if len(deliveries) > 1:
                seen: Dict[FrozenSet[int], int] = {}
                for contribs, i in deliveries:
                    if contribs in seen:
                        findings.append(finding(
                            PASS, "DUPLICATE_DELIVERY", "warning",
                            f"round {r_i}: chunk {c} delivered twice to "
                            f"rank {dst} with identical contributors "
                            f"(instrs {seen[contribs]} and {i})",
                            round=r_i, dst=dst, chunk=c))
                    else:
                        seen[contribs] = i
        for fop, dst, c, (contribs, prov) in updates:
            old = state[dst].get(c)
            if fop == "reduce":
                if old is not None and contribs <= old[0]:
                    n_no_effect += 1
                    findings.append(finding(
                        PASS, "NO_EFFECT_TRANSFER", "info",
                        f"round {r_i}: reduce into rank {dst} chunk {c} "
                        f"adds no new contributors", round=r_i))
                merged = old if old is not None else (frozenset(), frozenset())
                state[dst][c] = (merged[0] | contribs, merged[1] | prov)
            else:
                if old is not None and old[0] == contribs:
                    n_no_effect += 1
                    findings.append(finding(
                        PASS, "NO_EFFECT_TRANSFER", "info",
                        f"round {r_i}: copy to rank {dst} chunk {c} "
                        f"rewrites an identical entry", round=r_i))
                state[dst][c] = (contribs, prov)

    required = _required_entries(program, state)
    live: Set[int] = set()
    for (r, c) in required:
        entry = state[r].get(c)
        if entry is not None:
            live |= entry[1]
    dead = sorted(all_ids - live)
    if dead:
        findings.append(finding(
            PASS, "DEAD_TRANSFER", "warning",
            f"{len(dead)} instruction(s) outside the backward slice of "
            f"the {program.postcondition!r} postcondition (first ids: "
            f"{dead[:6]}) — transferred bytes never reach the result",
            count=len(dead), instr_ids=dead[:16]))
    stats: Dict[str, object] = {
        "n_live": len(live),
        "n_dead": len(dead),
        "n_no_effect": n_no_effect,
        "n_required_entries": len(required),
    }
    return findings, stats
