"""Optimality bounds: static cost vs the bandwidth lower bound.

For each collective kind there is a classic per-rank communication
lower bound (Chan et al., "Collective communication: theory, practice,
and experience"): with S total payload over n ranks, every allreduce
must move at least ``2(n-1)/n * S`` bytes through some rank's NIC, and
all-gather / reduce-scatter / all-to-all / rooted reduce at least
``(n-1)/n * S``.  The bound is keyed off the program's *postcondition*
— what it provably achieves — not the kind it registered under (bcube
registers as allreduce for cost-model parity but builds only the
reduce-scatter phase).

The program's statically derived cost uses the same single-port
full-duplex NIC model the bound assumes: a round costs the maximum over
ranks of bytes that rank sends (or receives, whichever is larger), and
rounds serialize.  The ratio ``lower_bound / static_cost`` is the
program's bandwidth efficiency:

* the chunked ring, halving-doubling, bcube, recursive-doubling and
  the shifted all-to-all all hit 1.0 exactly;
* the naive sequential ring lands at ``1/(2n)`` — the whole payload
  re-walks the ring twice with zero pipelining against its rooted
  ``reduce`` bound, which is precisely the paper's motivating regime;
* the latency side is reported alongside (executed rounds vs the
  ``ceil(log2 n)`` floor), not folded into one number.

Findings are info-level measurements: a low ratio is a property of the
chosen algorithm, not a bug in the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.collective.ir import Program

from .report import Finding, finding

__all__ = ["analyze_bounds", "bandwidth_lower_bound"]

PASS = "bounds"

#: per-rank wire-byte factors of S, by collective kind / postcondition
_LB_FACTOR = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "reduce": lambda n: (n - 1) / n,
}


def bandwidth_lower_bound(kind: str, size_bytes: float, n: int) -> float:
    """Minimum bytes through the busiest rank's NIC, by kind."""
    try:
        factor = _LB_FACTOR[kind]
    except KeyError:
        raise ValueError(f"no bandwidth lower bound for kind {kind!r}; "
                         f"known kinds: {tuple(_LB_FACTOR)}") from None
    return factor(max(n, 1)) * float(size_bytes)


def _bound_kind(program: Program) -> str:
    """The collective the program *provably* performs.

    The postcondition, not ``op.kind``: bcube registers under
    ``allreduce`` (legacy cost-model parity) but builds only the
    recursive reduce-scatter phase, and the naive sequential ring's
    typed proof stops at a rooted ``reduce`` — comparing either against
    the full-allreduce bound would misreport efficiency > 1 or < the
    algorithm's true ratio.
    """
    post = program.postcondition
    return post if post in _LB_FACTOR else program.op.kind


def analyze_bounds(
    program: Program,
) -> Tuple[List[Finding], Dict[str, object]]:
    n = program.n
    # chunk_factor-invariant: k repetitions at 1/k payload cost the same
    # in the pure-bandwidth model, so measure the base body at full size
    per_round_cost: List[float] = []
    for rnd in program.rounds:
        sent: Dict[int, float] = {}
        recv: Dict[int, float] = {}
        for f in rnd:
            sent[f.src] = sent.get(f.src, 0.0) + f.size
            recv[f.dst] = recv.get(f.dst, 0.0) + f.size
        per_round_cost.append(max(
            max(sent.values(), default=0.0),
            max(recv.values(), default=0.0)))
    static_cost = sum(per_round_cost)
    bound_kind = _bound_kind(program)
    lb = bandwidth_lower_bound(bound_kind, program.op.size_bytes, n)
    if static_cost <= 0.0:
        efficiency = 1.0            # n=1 degenerate: empty program is optimal
    else:
        efficiency = lb / static_cost
    rounds_executed = program.n_rounds
    log2_floor = int(math.ceil(math.log2(n))) if n > 1 else 0

    findings = [finding(
        PASS, "BANDWIDTH_EFFICIENCY", "info",
        f"{program.algorithm}: moves {static_cost:.0f} bytes through the "
        f"busiest rank vs a {lb:.0f}-byte lower bound for "
        f"{bound_kind} — efficiency {efficiency:.3f}; "
        f"{rounds_executed} rounds vs ceil(log2 n) = {log2_floor}",
        efficiency=round(efficiency, 6))]
    stats: Dict[str, object] = {
        "static_cost_bytes": static_cost,
        "bound_kind": bound_kind,
        "lower_bound_bytes": lb,
        "bandwidth_efficiency": round(efficiency, 6),
        "rounds_executed": rounds_executed,
        "log2_round_floor": log2_floor,
    }
    return findings, stats
