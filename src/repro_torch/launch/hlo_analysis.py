"""Collective accounting from optimized HLO text, and the roofline terms
(a copy of ``repro.launch.hlo_analysis``, which imports no JAX).

:func:`parse_collectives` sums the result bytes of every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute in an HLO
module's text, scaling an op inside a while body by the loop's trip count
(the largest integer constant of its condition; nested loops multiply).
:meth:`repro_torch.plan.JobMix.from_hlo` turns its rows into a job mix.
:func:`roofline_terms` gives the compute, memory and collective seconds
of a step at an :class:`HW`'s rates.

The port emits no HLO: :func:`parse_collectives`, :class:`CollectiveStats`
and ``JobMix.from_hlo`` read only text that XLA compiled (a JAX program's
``compile().as_text()``, or a dump of one), so a job mix taken from a
JAX run can be planned here.  The port's own dry run
(:mod:`repro_torch.launch.dryrun`) counts its collectives from its
runners instead, and feeds :func:`roofline_terms` at :class:`HW`.

:class:`HW`'s defaults are datasheet figures for an NVIDIA H100 80GB HBM3
(SXM) at its 700 W limit, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` names the card: ``NVIDIA H100 80GB HBM3, 700.00
W``.  They are the vendor's peak rates, not measurements.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["HW", "parse_collectives", "roofline_terms", "CollectiveStats"]


@dataclasses.dataclass(frozen=True)
class HW:
    """A card's peak rates (datasheet, NVIDIA H100 80GB HBM3 SXM, 700 W)."""

    peak_flops: float = 989.4e12      # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12           # HBM3 bytes/s per card
    ici_bw: float = 450e9             # NVLink bytes/s per card, one direction
    dcn_bw: float = 50e9              # bytes/s per card across hosts (400 Gb/s)
    hbm_per_chip: float = 80e9        # HBM bytes per card


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|\S+)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", )

_COLL_NAME_RE = re.compile(
    r"\s(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _result_bytes(line: str) -> float:
    """Bytes of the op result: all shapes between '=' and the op name
    (a tuple result sums its element shapes)."""
    lhs = line.split("=", 1)
    if len(lhs) != 2:
        return 0.0
    m_op = _COLL_NAME_RE.search(lhs[1])
    head = lhs[1][: m_op.start()] if m_op else lhs[1].split("(", 1)[0]
    total = 0.0
    for m in _SHAPE_RE.finditer(head):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_type: Dict[str, float]
    count_by_type: Dict[str, int]
    total_bytes: float
    details: List[Tuple[str, str, float, int]]  # (comp, op, bytes, mult)


def _computations(hlo: str) -> Dict[str, List[str]]:
    """Split HLO text into computation blocks (name -> lines)."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*{\s*$", line)
        m2 = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(", line)
        if (m or m2) and line.rstrip().endswith("{"):
            cur = (m or m2).group(1)
            comps[cur] = []
        elif cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    return comps


def _while_multipliers(hlo: str, comps: Dict[str, List[str]],
                       default_trip: int = 1) -> Dict[str, int]:
    """comp name -> product of trip counts of enclosing while loops.

    Trip counts come from the largest integer constant in the loop's
    condition computation (standard counted-loop lowering).  Nested
    loops multiply.
    """
    # find while ops: body=%name, condition=%name
    body_of: Dict[str, Tuple[str, str]] = {}  # body comp -> (cond comp, parent comp)
    for cname, lines in comps.items():
        for line in lines:
            if " while(" in line:
                mb = re.search(r"body=%?([\w\.\-]+)", line)
                mc = re.search(r"condition=%?([\w\.\-]+)", line)
                if mb and mc:
                    body_of[mb.group(1)] = (mc.group(1), cname)

    def trip(cond_name: str) -> int:
        best = default_trip
        for line in comps.get(cond_name, []):
            for m in re.finditer(r"constant\((\d+)\)", line):
                best = max(best, int(m.group(1)))
        return best

    # call graph: comp -> comps it calls (fusion/call/to_apply/body refs)
    calls: Dict[str, List[str]] = {c: [] for c in comps}
    ref_re = re.compile(
        r"(?:calls=|to_apply=|body=|condition=|branch_computations=\{)%?([\w\.\-]+)")
    for cname, lines in comps.items():
        for line in lines:
            for m in ref_re.finditer(line):
                if m.group(1) in comps:
                    calls[cname].append(m.group(1))

    mult: Dict[str, int] = {}

    def walk(c: str, factor: int, seen: frozenset) -> None:
        if c in seen:
            return
        mult[c] = max(mult.get(c, 0), factor)
        for child in calls.get(c, []):
            f = factor
            if child in body_of:
                f *= trip(body_of[child][0])
            walk(child, f, seen | {c})

    roots = [c for c in comps if "entry" in c.lower() or c.startswith("main")]
    if not roots:
        roots = list(comps)[:1]
    for r in roots:
        walk(r, 1, frozenset())
    # computations never reached from entry (conservative): factor 1
    for c in comps:
        mult.setdefault(c, 1)
    return mult


def parse_collectives(hlo: str, scale_loops: bool = True) -> CollectiveStats:
    comps = _computations(hlo)
    mults = _while_multipliers(hlo, comps) if scale_loops else {}
    bytes_by: Dict[str, float] = {}
    count_by: Dict[str, int] = {}
    details: List[Tuple[str, str, float, int]] = []
    for cname, lines in comps.items():
        factor = mults.get(cname, 1) if scale_loops else 1
        for line in lines:
            m = _COLL_RE.search(line)
            if not m:
                continue
            if "-done" in line.split("=", 1)[-1][:40]:
                continue  # async done ops repeat the start's result
            op = m.group(1)
            b = _result_bytes(line) * factor
            bytes_by[op] = bytes_by.get(op, 0.0) + b
            count_by[op] = count_by.get(op, 0) + factor
            details.append((cname, op, b, factor))
    return CollectiveStats(
        bytes_by_type=bytes_by,
        count_by_type=count_by,
        total_bytes=sum(bytes_by.values()),
        details=details,
    )


def roofline_terms(
    total_flops: float,
    total_hbm_bytes: float,
    total_collective_bytes: float,
    n_chips: int,
    hw: HW = HW(),
    dcn_collective_bytes: float = 0.0,
) -> Dict[str, float]:
    """The three roofline terms (seconds): compute, memory and collective
    time at ``hw``'s rates over ``n_chips`` cards, and the largest."""
    compute_s = total_flops / (n_chips * hw.peak_flops)
    memory_s = total_hbm_bytes / (n_chips * hw.hbm_bw)
    ici_bytes = total_collective_bytes - dcn_collective_bytes
    collective_s = (ici_bytes / (n_chips * hw.ici_bw)
                    + dcn_collective_bytes / (n_chips * hw.dcn_bw))
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda t: t[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
