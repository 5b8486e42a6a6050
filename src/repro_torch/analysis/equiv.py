"""Translation validation: certify a LoweredSchedule against its IR.

A copy of ``repro.analysis.equiv``.  The lowering in
:mod:`repro_torch.collective.executors` turns a validated
:class:`~repro_torch.collective.ir.Program` into per-round permute steps.
This pass *proves* — per artifact, not per compiler — that the two
describe the same collective, by symbolic execution of the schedule in
rank space over chunk→contributor sets, then chunk-for-chunk
bisimulation:

1. **Shape** — the schedule's placement, chunk metadata, pipelining
   factor, and round count must match the program's
   (``SCHEDULE_SHAPE``, error), and every step must be a well-formed
   partial permutation (``MALFORMED_STEP``, error).
2. **Per-round transfer multisets** — each IR round's ``(src rank,
   dst rank, chunk, op)`` multiset must equal the round's executed
   step transfers, where a link ``(s, d)`` executes iff
   ``send_mask[s] and recv_mask[d]``.  A schedule transfer the IR
   never asked for is ``EXTRA_TRANSFER``; a missing reduce is
   ``LOST_REDUCTION``; a missing or misrouted copy is
   ``MISMATCHED_DELIVERY`` (all errors).
3. **Final abstract state** — both sides are executed to completion
   under barrier semantics and the per-(rank, chunk) contributor sets
   must agree exactly (divergence is ``MISMATCHED_DELIVERY``).

:func:`require_certified` is the hard gate: the port's runners
(:mod:`repro_torch.kernels.schedule_runner`,
:mod:`repro_torch.kernels.overlap`, :mod:`repro_torch.train.overlap_grads`)
run only schedules it has passed; :func:`certify_stages` re-certifies a
program after each rewrite pass (``analyze --equiv``).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.collective.executors import LoweredSchedule, ScheduleLowering
from repro_torch.collective.ir import INITS, Program, _initial_state

from .report import Finding, Report, VerificationError, finding

__all__ = [
    "PASS",
    "analyze_equiv",
    "bisimulate",
    "certify_stages",
    "symbolic_execute",
    "require_certified",
]

PASS = "equiv"

#: abstract state: rank -> chunk id -> contributor rank set
State = Dict[int, Dict[int, FrozenSet[int]]]


def _schedule_initial_state(schedule: LoweredSchedule) -> State:
    """The lowered artifact's declared init, over chunk→contributor sets."""
    n = schedule.n
    full = frozenset(range(n))
    if schedule.init == "replicated":
        return {r: {c: frozenset((r,)) for c in range(schedule.n_chunks)}
                for r in range(n)}
    if schedule.init == "sharded":
        return {r: {r: full} for r in range(n)}
    if schedule.init == "addressed":
        return {s: {s * n + d: frozenset((s,)) for d in range(n)}
                for s in range(n)}
    raise ValueError(f"unknown init {schedule.init!r}; "
                     f"expected one of {INITS}")


def _check_steps(schedule: LoweredSchedule) -> List[Finding]:
    """Structural well-formedness of every PermuteStep."""
    findings: List[Finding] = []
    n = schedule.n
    for r_i, rnd in enumerate(schedule.rounds):
        for s_i, step in enumerate(rnd):
            if step.op not in ("reduce", "copy"):
                findings.append(finding(
                    PASS, "MALFORMED_STEP", "error",
                    f"round {r_i} step {s_i}: unknown op {step.op!r}",
                    round=r_i, step=s_i))
            if len(step.chunks) != len(step.links):
                findings.append(finding(
                    PASS, "MALFORMED_STEP", "error",
                    f"round {r_i} step {s_i}: {len(step.links)} links but "
                    f"{len(step.chunks)} chunk groups", round=r_i, step=s_i))
            if len(step.send_mask) != n or len(step.recv_mask) != n:
                findings.append(finding(
                    PASS, "MALFORMED_STEP", "error",
                    f"round {r_i} step {s_i}: masks sized "
                    f"{len(step.send_mask)}/{len(step.recv_mask)} for "
                    f"n={n}", round=r_i, step=s_i))
            srcs = [s for s, _ in step.links]
            dsts = [d for _, d in step.links]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                findings.append(finding(
                    PASS, "MALFORMED_STEP", "error",
                    f"round {r_i} step {s_i}: links {step.links} are not "
                    f"a partial permutation (duplicated endpoint)",
                    round=r_i, step=s_i))
            bad = [e for e in srcs + dsts if not 0 <= e < n]
            if bad:
                findings.append(finding(
                    PASS, "MALFORMED_STEP", "error",
                    f"round {r_i} step {s_i}: endpoint positions {bad} "
                    f"out of range for n={n}", round=r_i, step=s_i))
    return findings


def _round_transfers(
    schedule: LoweredSchedule, rnd, rank_of: Tuple[int, ...],
) -> Counter:
    """Executed ``(src rank, dst rank, chunk, op)`` multiset of a round.

    Honors the mask semantics: a link fires only when its source sends
    *and* its destination receives.
    """
    out: Counter = Counter()
    for step in rnd:
        for (s, d), chunks in zip(step.links, step.chunks):
            if not (0 <= s < schedule.n and 0 <= d < schedule.n):
                continue  # MALFORMED_STEP already filed
            if not (step.send_mask[s] and step.recv_mask[d]):
                continue
            for c in chunks:
                out[(rank_of[s], rank_of[d], c, step.op)] += 1
    return out


def symbolic_execute(schedule: LoweredSchedule) -> State:
    """Run the schedule in rank space over chunk→contributor sets.

    Rounds are barriers: all steps of a round read round-entry state
    and receives are applied together at the round boundary — exactly
    the staging discipline ``repro_torch.kernels.schedule_runner``
    implements on the card.  A send of an unheld chunk contributes nothing (the
    divergence surfaces in the final-state comparison).
    """
    rank_of = schedule.rank_of
    state = _schedule_initial_state(schedule)
    for rnd in schedule.rounds:
        updates: List[Tuple[str, int, int, FrozenSet[int]]] = []
        for step in rnd:
            for (s, d), chunks in zip(step.links, step.chunks):
                if not (0 <= s < schedule.n and 0 <= d < schedule.n):
                    continue
                if not (step.send_mask[s] and step.recv_mask[d]):
                    continue
                src, dst = rank_of[s], rank_of[d]
                for c in chunks:
                    held = state[src].get(c)
                    if held is None:
                        continue
                    updates.append((step.op, dst, c, held))
        for op, dst, c, contribs in updates:
            if op == "reduce":
                state[dst][c] = state[dst].get(c, frozenset()) | contribs
            else:
                state[dst][c] = contribs
    return state


def _program_final_state(program: Program) -> State:
    """ir.validate's abstract execution, state returned not judged."""
    state = _initial_state(program)
    for rnd in program.rounds:
        updates: List[Tuple[str, int, int, FrozenSet[int]]] = []
        for f in rnd:
            src_chunks = state[f.src]
            for c in f.chunks:
                held = src_chunks.get(c)
                if held is None:
                    continue  # validate owns the unheld-send error
                updates.append((f.op, f.dst, c, held))
        for op, dst, c, contribs in updates:
            if op == "reduce":
                state[dst][c] = state[dst].get(c, frozenset()) | contribs
            else:
                state[dst][c] = contribs
    return state


def bisimulate(
    program: Program,
    schedule: Optional[LoweredSchedule] = None,
) -> Tuple[List[Finding], Dict[str, object]]:
    """Prove ``schedule`` equivalent to ``program`` chunk-for-chunk.

    With ``schedule=None`` the program is lowered first.  Returns
    ``(findings, stats)``.
    """
    if schedule is None:
        schedule = ScheduleLowering().lower_schedule(program)
    findings: List[Finding] = []
    n = program.n

    # -- 1. shape ---------------------------------------------------------
    lp = tuple(int(i) for i in program.local_perm)
    shape_errs = []
    if schedule.n != n:
        shape_errs.append(f"n {schedule.n} != {n}")
    if tuple(schedule.order) != lp:
        shape_errs.append(f"order {schedule.order} != local_perm {lp}")
    if schedule.n_chunks != program.n_chunks:
        shape_errs.append(
            f"n_chunks {schedule.n_chunks} != {program.n_chunks}")
    if abs(schedule.chunk_bytes - program.chunk_bytes) > 1e-9 * max(
            program.chunk_bytes, 1.0):
        shape_errs.append(
            f"chunk_bytes {schedule.chunk_bytes} != {program.chunk_bytes}")
    if schedule.chunk_factor != program.chunk_factor:
        shape_errs.append(
            f"chunk_factor {schedule.chunk_factor} != "
            f"{program.chunk_factor}")
    if schedule.init != program.init:
        shape_errs.append(f"init {schedule.init!r} != {program.init!r}")
    if schedule.postcondition != program.postcondition:
        shape_errs.append(
            f"postcondition {schedule.postcondition!r} != "
            f"{program.postcondition!r}")
    if len(schedule.rounds) != len(program.rounds):
        shape_errs.append(
            f"{len(schedule.rounds)} lowered rounds != "
            f"{len(program.rounds)} IR rounds")
    for err in shape_errs:
        findings.append(finding(
            PASS, "SCHEDULE_SHAPE", "error",
            f"lowered schedule disagrees with program shape: {err}"))
    findings.extend(_check_steps(schedule))
    if any(f.severity == "error" for f in findings):
        # round/state comparison against a misshapen schedule would
        # only pile secondary findings on the primary one
        return findings, {"bisimilar": False,
                          "schedule_fingerprint": schedule.fingerprint()}

    # -- 2. per-round transfer multisets ----------------------------------
    rank_of = schedule.rank_of
    n_transfers = 0
    for r_i, (p_rnd, s_rnd) in enumerate(
            zip(program.rounds, schedule.rounds)):
        want: Counter = Counter()
        for f in p_rnd:
            for c in f.chunks:
                want[(f.src, f.dst, c, f.op)] += 1
        got = _round_transfers(schedule, s_rnd, rank_of)
        n_transfers += sum(got.values())
        extra = got - want
        missing = want - got
        for (src, dst, c, op), k in sorted(extra.items()):
            findings.append(finding(
                PASS, "EXTRA_TRANSFER", "error",
                f"round {r_i}: schedule executes {op} of chunk {c} "
                f"{src}→{dst} ({k}x) the program never issues",
                round=r_i, src=src, dst=dst, chunk=c))
        for (src, dst, c, op), k in sorted(missing.items()):
            code = "LOST_REDUCTION" if op == "reduce" \
                else "MISMATCHED_DELIVERY"
            findings.append(finding(
                PASS, code, "error",
                f"round {r_i}: program {op} of chunk {c} {src}→{dst} "
                f"({k}x) is not executed by the lowered schedule",
                round=r_i, src=src, dst=dst, chunk=c))

    # -- 3. final abstract state ------------------------------------------
    want_state = _program_final_state(program)
    got_state = symbolic_execute(schedule)
    n_mismatched = 0
    for r in range(n):
        chunks = set(want_state.get(r, ())) | set(got_state.get(r, ()))
        for c in sorted(chunks):
            w = want_state.get(r, {}).get(c)
            g = got_state.get(r, {}).get(c)
            if w != g:
                n_mismatched += 1
                if n_mismatched <= 8:  # cap the flood; the count is in stats
                    findings.append(finding(
                        PASS, "MISMATCHED_DELIVERY", "error",
                        f"final state diverges at rank {r} chunk {c}: "
                        f"program holds contributors "
                        f"{sorted(w) if w else w}, schedule holds "
                        f"{sorted(g) if g else g}", dst=r, chunk=c))

    ok = not any(f.severity == "error" for f in findings)
    stats: Dict[str, object] = {
        "bisimilar": ok,
        "n_steps": schedule.n_steps,
        "n_transfers": n_transfers,
        "n_mismatched_entries": n_mismatched,
        "max_steps_per_round": max(
            (len(r) for r in schedule.rounds), default=0),
        "schedule_fingerprint": schedule.fingerprint(),
    }
    return findings, stats


def require_certified(program: Program,
                      schedule: Optional[LoweredSchedule] = None) -> Dict[
                          str, object]:
    """Bisimulate and raise :class:`VerificationError` on any error.

    The hard gate every schedule passes before the port runs it;
    returns the stats (which carry the certified
    ``schedule_fingerprint``) on success.
    """
    findings, stats = bisimulate(program, schedule)
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        report = Report(algorithm=program.algorithm, kind=program.op.kind,
                        n=program.n,
                        program_fingerprint=program.fingerprint(),
                        findings=findings, stats={PASS: stats},
                        passes_run=[PASS])
        raise VerificationError(
            f"lowered schedule for {program.algorithm} (n={program.n}, "
            f"kind={program.op.kind}) failed translation validation with "
            f"{len(errors)} error(s): {errors[0].code} — "
            f"{errors[0].message}", report=report)
    return stats


def certify_stages(
    program: Program,
    perm: Optional[Tuple[int, ...]] = None,
    chunk_k: int = 1,
    fuse: bool = True,
) -> List[Dict[str, object]]:
    """Differential translation validation across the rewrite passes.

    Starting from ``program`` (stage ``base``), applies each rewrite in
    the compiler's order — ``apply_permutation(perm)``, ``chunk(k)``,
    ``fuse_rounds`` — re-lowering and re-bisimulating after every one.
    Returns one verdict dict per executed stage::

        {"stage", "ok", "n_findings", "codes", "stats",
         "program_fingerprint"}

    A lowering bug that only manifests after a particular rewrite
    (e.g. fusion changing the step packing) is pinned to its stage.
    Stages whose rewrite is a no-op (identity perm / k=1 / nothing to
    fuse) still certify — the proof is cheap and the matrix stays
    rectangular.  ``analyze --equiv`` runs it over every builder.
    """
    from repro_torch.collective.passes import apply_permutation, chunk, fuse_rounds

    out: List[Dict[str, object]] = []
    current = program

    def run(stage: str, prog: Program) -> None:
        findings, stats = bisimulate(prog)
        out.append({
            "stage": stage,
            "ok": not any(f.severity == "error" for f in findings),
            "n_findings": len(findings),
            "codes": sorted({f.code for f in findings}),
            "stats": stats,
            "program_fingerprint": prog.fingerprint(),
        })

    run("base", current)
    if perm is not None:
        current = apply_permutation(current, perm)
        run("apply_permutation", current)
    if chunk_k > 1:
        current = chunk(current, chunk_k)
        run("chunk", current)
    if fuse:
        current, _ = fuse_rounds(current, verify=False)
        run("fuse_rounds", current)
    return out


def analyze_equiv(
    program: Program,
) -> Tuple[List[Finding], Dict[str, object]]:
    """The registered pass form: lower ``program`` and certify the pair."""
    return bisimulate(program)
