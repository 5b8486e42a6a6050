"""AST-level custom lint: repo conventions generic linters can't see.

A copy of ``repro.analysis.lint``: the seven rules, their messages, the
path prefixes that scope them (``src/repro/...``) and the waiver are the
reference's, so ``python -m repro_torch analyze --lint`` and ``python -m
repro analyze --lint`` give the same findings on the same tree.  No rule
is scoped to the port's own package.

Seven rules, each born from a real convention this codebase adopted and
then had to re-fix by hand at least once:

* ``raw-perf-counter`` — ``time.perf_counter`` outside ``repro/obs``.
  PR 7 centralized wall-clock measurement behind ``obs.tracer().timer``
  so capture/replay can virtualize the clock; a raw perf_counter pair
  is invisible to trace capture and silently wrong under replay.
  Scope: ``src/repro`` only (tests and benchmarks may time freely).
* ``warn-stacklevel`` — every ``warnings.warn`` call must pass
  ``stacklevel`` so the warning points at the *caller*, not the
  library line.  Scope: everything scanned.
* ``toplevel-jax-import`` — the planning layers (core, fabric, plan,
  session, faults, obs, analysis, the collective IR, the CLI) must be
  importable without jax; only the jax-native packages (kernels,
  models, parallel, train, optim, serve, data, checkpoint, launch
  specs, the collective executors) may import it at module level.
  Imports guarded by ``try/except ImportError`` or
  ``if TYPE_CHECKING`` don't count.
* ``deprecation-warning-category`` — a ``warnings.warn`` whose message
  mentions deprecation must pass ``DeprecationWarning`` (or
  ``FutureWarning``), otherwise ``-W error::DeprecationWarning`` CI
  runs and downstream filters never see it.
* ``lowered-construction`` — ``Lowered`` / ``LoweredSchedule`` /
  ``PermuteStep`` may only be constructed in
  ``collective/executors.py`` (the one certified lowering path) and
  ``repro.analysis`` (the translation validator and its mutant
  screen).  A schedule constructed anywhere else never went through
  ``equiv`` bisimulation, so a runtime consuming it would execute an
  unproven schedule.  Scope: ``src/repro`` (tests may build fixtures).
* ``direct-schedule-run`` — the workload layers (``train/``,
  ``serve/``) must not call ``run_schedule`` directly: the certified
  schedule reaches a step fused (``repro.kernels.overlap`` /
  ``OverlapGradReducer``) or via ``Session``, which pin the
  certification boundary and keep the overlap accounting (bucket
  records, exposed-comm spans) truthful.  A bare ``run_schedule``
  call bypasses both.  Scope: ``src/repro/train``, ``src/repro/serve``.
* ``module-level-np-random`` — legacy global-state ``np.random.*``
  calls (``seed``, ``rand``, ``normal``...) at module import time make
  results depend on import order; use a seeded
  ``np.random.default_rng`` (or ``RandomState``) inside the code that
  needs it.  Seeded constructors are exempt.  Scope: everything
  scanned.

Waivers: append ``# lint: allow(<rule-name>)`` to the offending line
(or the line directly above).  Waivers are for load-bearing exceptions
— the probe's RTT measurement *is* the clock; the solver's hot-loop
timeout cannot take a tracer import — and each one should say why in a
neighboring comment.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["RULES", "LintFinding", "lint_file", "lint_repo",
           "iter_python_files"]

#: rule name -> one-line description (the registry the CLI prints)
RULES: Dict[str, str] = {
    "raw-perf-counter":
        "time.perf_counter outside repro/obs (use obs.tracer().timer)",
    "warn-stacklevel":
        "warnings.warn without stacklevel=",
    "toplevel-jax-import":
        "unguarded module-level jax import in a planning layer",
    "deprecation-warning-category":
        "deprecation message warned without DeprecationWarning",
    "lowered-construction":
        "Lowered/LoweredSchedule/PermuteStep built outside the "
        "certified lowering path (collective/executors.py + analysis)",
    "module-level-np-random":
        "legacy np.random.* global-state call at module import time",
    "direct-schedule-run":
        "run_schedule called from train/ or serve/ (go through the "
        "overlap layer or Session)",
}

#: src/repro-relative prefixes allowed to import jax at module level
_JAX_NATIVE = (
    "kernels/", "models/", "parallel/", "train/", "optim/", "serve/",
    "data/", "checkpoint/",
    "launch/specs.py", "collective/executors.py",
)

_WAIVER = "# lint: allow("


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One rule violation at one source location."""

    rule: str
    path: str          # repo-relative
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _waived(lines: Sequence[str], lineno: int, rule: str) -> bool:
    """True when the line (or the one above) carries an allow waiver."""
    token = f"{_WAIVER}{rule})"
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and token in lines[ln - 1]:
            return True
    return False


def _is_jax_import(node: ast.stmt) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name == "jax" or a.name.startswith("jax.")
                   for a in node.names)
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        return node.level == 0 and (mod == "jax" or mod.startswith("jax."))
    return False


def _module_level_jax_imports(tree: ast.Module) -> List[ast.stmt]:
    """Unguarded module-level jax imports (try/except and TYPE_CHECKING
    blocks don't count — those are the sanctioned guards)."""
    out: List[ast.stmt] = []
    for node in tree.body:
        if _is_jax_import(node):
            out.append(node)
        elif isinstance(node, ast.If):
            # "if TYPE_CHECKING:" guards typing-only imports
            t = node.test
            is_tc = (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") \
                or (isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")
            if not is_tc:
                out.extend(s for s in node.body if _is_jax_import(s))
        # ast.Try at module level is the other guard: don't descend
    return out


def _is_warnings_warn(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "warn" and \
            isinstance(f.value, ast.Name) and f.value.id == "warnings":
        return True
    return isinstance(f, ast.Name) and f.id == "warn"


def _string_parts(node: ast.AST) -> Iterable[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _warn_category(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "category":
            return kw.value
    if len(call.args) >= 2:
        return call.args[1]
    return None


def _category_name(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _check_warn_calls(tree: ast.Module, rel: str,
                      lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_warnings_warn(node)):
            continue
        if not any(kw.arg == "stacklevel" for kw in node.keywords) and \
                len(node.args) < 3:
            if not _waived(lines, node.lineno, "warn-stacklevel"):
                findings.append(LintFinding(
                    "warn-stacklevel", rel, node.lineno,
                    "warnings.warn without stacklevel= — the warning "
                    "will point at the library, not the caller"))
        msg_mentions_deprecation = node.args and any(
            "deprecat" in s.lower() for s in _string_parts(node.args[0]))
        if msg_mentions_deprecation:
            cat = _category_name(_warn_category(node))
            if cat not in ("DeprecationWarning", "FutureWarning",
                           "PendingDeprecationWarning"):
                if not _waived(lines, node.lineno,
                               "deprecation-warning-category"):
                    findings.append(LintFinding(
                        "deprecation-warning-category", rel, node.lineno,
                        f"deprecation message warned with category "
                        f"{cat or 'UserWarning (default)'} — use "
                        f"DeprecationWarning so -W filters catch it"))
    return findings


def _check_perf_counter(tree: ast.Module, rel: str,
                        lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        lineno = None
        if isinstance(node, ast.Attribute) and node.attr == "perf_counter":
            lineno = node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module == "time" and \
                any(a.name == "perf_counter" for a in node.names):
            lineno = node.lineno
        if lineno is not None and \
                not _waived(lines, lineno, "raw-perf-counter"):
            findings.append(LintFinding(
                "raw-perf-counter", rel, lineno,
                "raw time.perf_counter — use obs.tracer().timer() / "
                ".span() so capture/replay can virtualize the clock"))
    return findings


def _check_jax_imports(tree: ast.Module, rel: str,
                       lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for node in _module_level_jax_imports(tree):
        if not _waived(lines, node.lineno, "toplevel-jax-import"):
            findings.append(LintFinding(
                "toplevel-jax-import", rel, node.lineno,
                "unguarded module-level jax import in a planning layer "
                "— import lazily inside the function, or guard with "
                "try/except ImportError"))
    return findings


#: src/repro-relative prefixes allowed to construct lowering artifacts
_LOWERING_PATH = ("collective/executors.py", "analysis/")

#: the lowering artifact class names the rule guards
_LOWERED_NAMES = ("Lowered", "LoweredSchedule", "PermuteStep")

#: np.random attributes that are seeded constructors, not global state
_NP_RANDOM_SEEDED = ("default_rng", "Generator", "RandomState",
                     "SeedSequence", "PCG64", "Philox", "MT19937",
                     "bit_generator")


def _check_lowered_construction(tree: ast.Module, rel: str,
                                lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name not in _LOWERED_NAMES:
            continue
        if not _waived(lines, node.lineno, "lowered-construction"):
            findings.append(LintFinding(
                "lowered-construction", rel, node.lineno,
                f"{name} constructed outside the certified lowering "
                f"path — schedules must come from JaxExecutor.lower "
                f"(collective/executors.py) so equiv bisimulation "
                f"covers them"))
    return findings


#: src/repro-relative prefixes barred from calling run_schedule directly
_WORKLOAD_LAYERS = ("train/", "serve/")


def _check_direct_schedule_run(tree: ast.Module, rel: str,
                               lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name != "run_schedule":
            continue
        if not _waived(lines, node.lineno, "direct-schedule-run"):
            findings.append(LintFinding(
                "direct-schedule-run", rel, node.lineno,
                "run_schedule called from a workload layer — fuse the "
                "certified schedule via repro.kernels.overlap "
                "(run_overlapped / OverlapGradReducer) or go through "
                "Session, so the certification boundary and overlap "
                "accounting hold"))
    return findings


def _module_level_calls(tree: ast.Module) -> List[ast.Call]:
    """Call nodes executed at import time: module and class bodies,
    but nothing inside a function/lambda/comprehension-lambda."""
    out: List[ast.Call] = []

    def visit(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.ClassDef):
                visit(stmt.body)
                continue
            for node in ast.walk(stmt):
                if isinstance(node, ast.Lambda):
                    continue
                if isinstance(node, ast.Call):
                    out.append(node)

    visit(tree.body)
    return out


def _check_np_random(tree: ast.Module, rel: str,
                     lines: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    # lambdas defer execution: prune calls inside them
    deferred = {id(c) for stmt in ast.walk(tree)
                if isinstance(stmt, ast.Lambda)
                for c in ast.walk(stmt) if isinstance(c, ast.Call)}
    for node in _module_level_calls(tree):
        if id(node) in deferred:
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "random"
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id in ("np", "numpy")):
            continue
        if f.attr in _NP_RANDOM_SEEDED:
            continue
        if not _waived(lines, node.lineno, "module-level-np-random"):
            findings.append(LintFinding(
                "module-level-np-random", rel, node.lineno,
                f"np.random.{f.attr} at module import time mutates "
                f"global RNG state — use a seeded "
                f"np.random.default_rng inside the consuming code"))
    return findings


def lint_file(path: str, root: str) -> List[LintFinding]:
    """All rule violations in one file; ``root`` anchors scoping."""
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding("syntax", rel, e.lineno or 0,
                            f"file does not parse: {e.msg}")]
    lines = src.splitlines()

    findings = _check_warn_calls(tree, rel, lines)
    in_repro = rel.startswith("src/repro/")
    if in_repro and not rel.startswith("src/repro/obs/"):
        findings.extend(_check_perf_counter(tree, rel, lines))
    if in_repro:
        sub = rel[len("src/repro/"):]
        if not any(sub.startswith(p) for p in _JAX_NATIVE):
            findings.extend(_check_jax_imports(tree, rel, lines))
        if not any(sub.startswith(p) for p in _LOWERING_PATH):
            findings.extend(_check_lowered_construction(tree, rel, lines))
        if any(sub.startswith(p) for p in _WORKLOAD_LAYERS):
            findings.extend(_check_direct_schedule_run(tree, rel, lines))
    findings.extend(_check_np_random(tree, rel, lines))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def iter_python_files(root: str,
                      subdirs: Sequence[str] = ("src", "tests",
                                                "benchmarks", "examples"),
                      ) -> List[str]:
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f)
                       for f in filenames if f.endswith(".py"))
    return sorted(out)


def lint_repo(root: str,
              paths: Optional[Sequence[str]] = None,
              ) -> Tuple[List[LintFinding], int]:
    """Lint the repo (or explicit ``paths``); returns (findings, n_files)."""
    files = list(paths) if paths else iter_python_files(root)
    findings: List[LintFinding] = []
    for f in files:
        findings.extend(lint_file(f, root))
    return findings, len(files)
