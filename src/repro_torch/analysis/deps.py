"""Deadlock / dependency analysis over a typed collective ``Program``
(a copy of ``repro.analysis.deps``).

Builds the send/recv dependency graph in *data-flow* terms: instruction
B depends on instruction A when B forwards a chunk that A delivered to
B's source rank earlier.  Under the IR's barrier semantics (flows within
a round read round-entry state) every legal dependency points strictly
backwards in round order, so the graph of a correct program is acyclic
by construction — this pass *proves* it by detecting the two ways a
(generated or mutated) program can break the property:

* **intra-round race** — a flow sends a chunk its source only receives
  in the *same* round.  A barrier executor has no defined value to
  send; a rendezvous executor must order the two transfers, and if the
  needs are mutual it deadlocks.
* **missing data** — a flow sends a chunk its source never receives at
  all (also caught by ``ir.validate``'s abstract interpretation; the
  dependency pass reports it with the producing-round evidence so the
  verifier stands alone).

It also reports the critical-path depth (the longest dependency chain,
in instructions), the latency shape every bounds/contention consumer
keys off.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.collective.ir import Program

from .report import Finding, Report, VerificationError, finding

__all__ = ["analyze_dependencies", "initial_chunks", "require_acyclic"]

PASS = "deps"


def initial_chunks(program: Program) -> List[Set[int]]:
    """Chunk ids each rank holds before round 0 (id space, not contribs)."""
    n = program.n
    if program.init == "replicated":
        return [set(range(program.n_chunks)) for _ in range(n)]
    if program.init == "sharded":
        return [{r} for r in range(n)]
    if program.init == "addressed":
        return [{r * n + d for d in range(n)} for r in range(n)]
    raise ValueError(f"unknown init {program.init!r}")


def analyze_dependencies(
    program: Program,
) -> Tuple[List[Finding], Dict[str, object]]:
    """Findings + stats; see the module docstring for the contract."""
    findings: List[Finding] = []
    held = initial_chunks(program)
    #: (rank, chunk) -> instr id of the latest delivery in an earlier round
    last_producer: Dict[Tuple[int, int], int] = {}
    #: consumer instr id -> producer instr ids (cross-round data edges)
    edges: Dict[int, List[int]] = {}
    depth: Dict[int, int] = {}
    instr_id = 0
    n_instrs = 0
    max_fan_in = 0

    for r_i, rnd in enumerate(program.rounds):
        if not rnd:
            findings.append(finding(
                PASS, "EMPTY_ROUND", "warning",
                f"round {r_i} contains no flows — dead barrier "
                f"(a dropped instruction or a degenerate builder)",
                round=r_i))
            continue
        # same-round deliveries, for race detection (barrier semantics:
        # these are NOT visible to this round's senders)
        delivered_now: Dict[Tuple[int, int], List[int]] = {}
        ids = list(range(instr_id, instr_id + len(rnd)))
        for i, f in zip(ids, rnd):
            for c in f.chunks:
                delivered_now.setdefault((f.dst, c), []).append(i)
        intra_edges: Dict[int, List[int]] = {}
        for i, f in zip(ids, rnd):
            if f.src == f.dst and program.n > 1:
                findings.append(finding(
                    PASS, "SELF_SEND", "error",
                    f"round {r_i}: rank {f.src} sends to itself "
                    f"(chunks {list(f.chunks)[:4]})", round=r_i,
                    src=f.src))
                continue
            producers: List[int] = []
            for c in f.chunks:
                prod = last_producer.get((f.src, c))
                if prod is not None:
                    producers.append(prod)
                elif c not in held[f.src]:
                    same_round = [j for j in delivered_now.get((f.src, c), ())
                                  if j != i]
                    if same_round:
                        findings.append(finding(
                            PASS, "INTRA_ROUND_RACE", "error",
                            f"round {r_i}: rank {f.src} sends chunk {c} "
                            f"that is only delivered to it within the same "
                            f"round — undefined under barrier semantics, "
                            f"rendezvous-order dependent otherwise",
                            round=r_i, src=f.src, dst=f.dst, chunk=c))
                        intra_edges.setdefault(i, []).extend(same_round)
                    else:
                        findings.append(finding(
                            PASS, "MISSING_DATA", "error",
                            f"round {r_i}: rank {f.src} sends chunk {c} "
                            f"it never held nor received",
                            round=r_i, src=f.src, dst=f.dst, chunk=c))
            if producers:
                edges[i] = producers
                max_fan_in = max(max_fan_in, len(set(producers)))
            # a producer skipped as SELF_SEND has no depth: floor it at 1
            depth[i] = 1 + max((depth.get(p, 1) for p in producers),
                               default=0)
        # mutual intra-round needs are a rendezvous deadlock cycle
        for i, needs in intra_edges.items():
            for j in needs:
                if i in intra_edges.get(j, ()):  # pragma: no branch
                    findings.append(finding(
                        PASS, "DEADLOCK_CYCLE", "error",
                        f"round {r_i}: instructions {min(i, j)} and "
                        f"{max(i, j)} each need the chunk the other "
                        f"delivers in the same round — rendezvous deadlock",
                        round=r_i))
                    break
        # barrier: commit this round's deliveries
        for (dst, c), prods in delivered_now.items():
            held[dst].add(c)
            last_producer[(dst, c)] = max(prods)
        n_instrs += len(rnd)
        instr_id += len(rnd)

    critical_path = max(depth.values(), default=0)
    stats: Dict[str, object] = {
        "n_instrs": n_instrs,
        "n_rounds": program.n_rounds,
        "critical_path_depth": critical_path * program.chunk_factor,
        "max_fan_in": max_fan_in,
        "acyclic": not any(f.code in ("DEADLOCK_CYCLE", "INTRA_ROUND_RACE")
                           for f in findings),
    }
    return findings, stats


def require_acyclic(program: Program) -> Dict[str, object]:
    """Run the dependency pass; raise :class:`VerificationError` on errors.

    The gate :func:`repro_torch.collective.passes.fuse_rounds` applies
    after fusing (the reference's ``require_valid(passes=("deps",))``).
    """
    findings, stats = analyze_dependencies(program)
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        report = Report(algorithm=program.algorithm, kind=program.op.kind,
                        n=program.n,
                        program_fingerprint=program.fingerprint(),
                        findings=findings, stats={PASS: stats},
                        passes_run=[PASS])
        raise VerificationError(
            f"{program.algorithm} (n={program.n}) failed the dependency "
            f"pass with {len(errors)} error(s): {errors[0].code} — "
            f"{errors[0].message}", report=report)
    return stats
