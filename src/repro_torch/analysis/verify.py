"""The pass driver: run registered analyses, aggregate one Report.

``verify_program`` is the single entry point every consumer uses — the
plan compiler's candidate gate, ``Session.lower``'s pre-flight check,
``fuse_rounds``'s post-condition, the CLI sweep, and the mutant screen
all call it with different pass subsets and context.

The registry is ordered: cheap structural proof first, semantics next,
then the measurements.  A pass that *raises* is itself a verification
failure (PASS_CRASH, error) rather than an analysis escape hatch — a
verifier that silently skips a crashed pass proves nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.collective import ir
from repro_torch.collective.ir import Program

from . import bounds as _bounds
from . import contention as _contention
from . import deps as _deps
from . import equiv as _equiv
from . import liveness as _liveness
from .report import Finding, Report, VerificationError, finding

__all__ = ["PASSES", "PassContext", "verify_program", "require_valid"]


@dataclasses.dataclass
class PassContext:
    """Optional environment a pass may consult; all fields may be None."""

    fabric: Optional[object] = None          # repro_torch.fabric.Fabric
    hierarchy: Optional[object] = None       # repro_torch.fabric.HierarchyModel
    lat: Optional[np.ndarray] = None         # probed latency matrix
    bw: Optional[np.ndarray] = None          # probed bandwidth matrix
    oversub_threshold: float = 2.0

    @property
    def has_topology(self) -> bool:
        return (self.fabric is not None or self.hierarchy is not None
                or self.lat is not None)


def _run_validate(program: Program,
                  ctx: PassContext) -> Tuple[List[Finding], Dict[str, object]]:
    """ir.validate as a pass: invariant violations become error findings."""
    try:
        ir.validate(program)
    except ir.ProgramInvariantError as e:
        return [finding("validate", "INVARIANT_VIOLATION", "error", str(e))], {}
    return [], {"structural": True, "semantic": True}


def _run_deps(program, ctx):
    return _deps.analyze_dependencies(program)


def _run_liveness(program, ctx):
    return _liveness.analyze_liveness(program)


def _run_equiv(program, ctx):
    return _equiv.analyze_equiv(program)


def _run_bounds(program, ctx):
    return _bounds.analyze_bounds(program)


def _run_contention(program, ctx):
    return _contention.analyze_contention(
        program, fabric=ctx.fabric, hierarchy=ctx.hierarchy,
        lat=ctx.lat, bw=ctx.bw, oversub_threshold=ctx.oversub_threshold)


#: ordered registry: name -> pass(program, ctx) -> (findings, stats)
PASSES: Dict[str, Callable[[Program, PassContext],
                           Tuple[List[Finding], Dict[str, object]]]] = {
    "validate": _run_validate,
    "deps": _run_deps,
    "liveness": _run_liveness,
    "equiv": _run_equiv,
    "bounds": _run_bounds,
    "contention": _run_contention,
}

#: passes that prove correctness (the gate set); measurements excluded.
#: ``equiv`` makes every compile gate a translation-validation gate:
#: the program is lowered and the schedule bisimulated as part of
#: passing verification.
GATE_PASSES = ("validate", "deps", "liveness", "equiv")


def verify_program(
    program: Program,
    passes: Optional[Sequence[str]] = None,
    fabric=None,
    hierarchy=None,
    lat=None,
    bw=None,
    oversub_threshold: float = 2.0,
) -> Report:
    """Run ``passes`` (default: all registered) and aggregate a Report.

    The contention pass degrades gracefully to a no-op without topology
    context, so running "all" passes is always safe.
    """
    ctx = PassContext(fabric=fabric, hierarchy=hierarchy, lat=lat, bw=bw,
                      oversub_threshold=oversub_threshold)
    names = list(passes) if passes is not None else list(PASSES)
    unknown = [p for p in names if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown analysis pass(es) {unknown}; "
                         f"registered: {tuple(PASSES)}")
    report = Report(algorithm=program.algorithm, kind=program.op.kind,
                    n=program.n, program_fingerprint=program.fingerprint())
    for name in names:
        try:
            findings, stats = PASSES[name](program, ctx)
        except Exception as e:  # noqa: BLE001 — a crashed pass is a verdict
            findings, stats = [finding(
                name, "PASS_CRASH", "error",
                f"analysis pass {name!r} crashed: "
                f"{type(e).__name__}: {e}")], {}
        report.findings.extend(findings)
        if stats:
            report.stats[name] = stats
        report.passes_run.append(name)
    return report


def require_valid(program: Program, **context) -> Report:
    """Verify and raise :class:`VerificationError` on any error finding.

    The hard-gate form used by the plan compiler and ``Session.lower``;
    returns the (possibly warning-bearing) report when the program is
    sound so callers can still surface the measurements.
    """
    report = verify_program(program, **context)
    if not report.ok:
        errors = report.by_severity("error")
        raise VerificationError(
            f"program {program.algorithm} (n={program.n}, "
            f"kind={program.op.kind}) failed static verification with "
            f"{len(errors)} error(s): {errors[0].code} — {errors[0].message}",
            report=report)
    return report
