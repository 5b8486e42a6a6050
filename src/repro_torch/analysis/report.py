"""Findings and reports: the verdict taxonomy of `repro_torch.analysis`
(a copy of ``repro.analysis.report``).

Every analysis pass returns :class:`Finding`\\ s at one of three
severities:

* ``error``   — the program is *wrong*: executing it would deadlock,
  lose data, or violate its declared postcondition.  Errors are hard
  gates: the plan compiler refuses to score such a program and
  :func:`repro_torch.analysis.require_certified` raises.
* ``warning`` — the program is suspicious in a way a generated schedule
  should never be (an adjacent duplicated round, an oversubscribed link
  dominating a round) but a human-written algorithm might exhibit on
  purpose.  Warnings fail mutant screening, not compilation.
* ``info``    — measurements, not judgments: bandwidth-efficiency
  ratios, critical-path depth, congestion histograms.

A :class:`Report` aggregates the findings of one verification run plus
per-pass stats; its :meth:`Report.ok` / :meth:`Report.clean` properties
are the two gate levels above.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["SEVERITIES", "Finding", "Report", "VerificationError"]

#: ordered weakest-to-strongest; gates compare by index
SEVERITIES = ("info", "warning", "error")


class VerificationError(ValueError):
    """A program failed static verification (error-level findings).

    Carries the offending :class:`Report` as ``.report`` so callers can
    surface the full finding list, not just the first message.
    """

    def __init__(self, message: str, report: Optional["Report"] = None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verdict from one analysis pass."""

    pass_name: str                 # registered pass that produced it
    code: str                      # stable machine code, e.g. "DEADLOCK_CYCLE"
    severity: str                  # one of SEVERITIES
    message: str                   # human-readable, names the evidence
    round: Optional[int] = None    # round index the finding anchors to
    detail: Tuple[Tuple[str, object], ...] = ()   # sorted extra evidence

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")

    def to_dict(self) -> dict:
        d = {"pass": self.pass_name, "code": self.code,
             "severity": self.severity, "message": self.message}
        if self.round is not None:
            d["round"] = self.round
        if self.detail:
            d["detail"] = dict(self.detail)
        return d


def finding(pass_name: str, code: str, severity: str, message: str,
            round: Optional[int] = None, **detail) -> Finding:
    """Convenience constructor normalizing the detail dict to a tuple."""
    return Finding(pass_name=pass_name, code=code, severity=severity,
                   message=message, round=round,
                   detail=tuple(sorted(detail.items())))


@dataclasses.dataclass
class Report:
    """The verdict of one verification run."""

    algorithm: str
    kind: str
    n: int
    program_fingerprint: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    #: per-pass measurements, e.g. {"deps": {"critical_path_depth": 14}}
    stats: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict)
    passes_run: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """No error-level findings: safe to compile, lower, and execute."""
        return not any(f.severity == "error" for f in self.findings)

    @property
    def clean(self) -> bool:
        """No error- or warning-level findings (the mutant-screen gate)."""
        return not any(f.severity in ("error", "warning")
                       for f in self.findings)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def summary(self) -> str:
        """One line: ``ring n=8 OK (0 err, 0 warn, 2 info)``."""
        counts = {s: len(self.by_severity(s)) for s in SEVERITIES}
        verdict = "OK" if self.ok else "FAIL"
        return (f"{self.algorithm} n={self.n} {verdict} "
                f"({counts['error']} err, {counts['warning']} warn, "
                f"{counts['info']} info)")

    def describe(self) -> str:
        """Multi-line report: summary + every non-info finding + stats."""
        lines = [self.summary()]
        for f in self.findings:
            if f.severity == "info":
                continue
            where = f" round {f.round}" if f.round is not None else ""
            lines.append(f"  [{f.severity}] {f.code}{where}: {f.message}")
        for pname, st in self.stats.items():
            kv = " ".join(f"{k}={v}" for k, v in sorted(st.items())
                          if not isinstance(v, (list, dict)))
            if kv:
                lines.append(f"  {pname}: {kv}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "kind": self.kind,
            "n": self.n,
            "program_fingerprint": self.program_fingerprint,
            "ok": self.ok,
            "clean": self.clean,
            "findings": [f.to_dict() for f in self.findings],
            "stats": self.stats,
            "passes_run": list(self.passes_run),
        }
