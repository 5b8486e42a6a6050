"""Composable rewrite passes over :class:`~repro_torch.collective.ir.Program`
(a copy of ``repro.collective.passes``).

Passes are pure ``Program -> Program`` functions; they compose freely
and never mutate their input.  The three seed passes:

* :func:`apply_permutation` — rank reordering (the paper's object) as a
  rewrite instead of a ``perm`` argument threaded through every builder;
* :func:`chunk` — serialized pipelining: k pieces of 1/k payload (the
  chunking dimension the plan compiler scores);
* :func:`fuse_rounds` — merge adjacent rounds with disjoint
  participants (barrier elimination that cannot reorder a data
  dependency).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .ir import Program

__all__ = ["apply_permutation", "chunk", "fuse_rounds"]


def apply_permutation(program: Program, perm: Sequence[int]) -> Program:
    """Place rank r on node ``perm[r]``.

    ``perm`` may be given in node-id space (a rearrangement of
    ``program.op.group`` — the plan compiler's convention) or in local
    index space (a permutation of ``range(n)``, composed through the
    group).  Because flows live in rank space, the pass only rewrites
    the rank→node mapping; the schedule structure is untouched — which
    is exactly the permutation-independence invariant the legacy
    builders maintained implicitly.
    """
    n = program.n
    perm = tuple(int(p) for p in perm)
    if len(perm) != n:
        raise ValueError(
            f"perm has {len(perm)} entries for a {n}-rank program")
    group = program.op.group
    if sorted(perm) == sorted(group):
        node_perm = perm
    elif sorted(perm) == list(range(n)):
        ordered = tuple(sorted(group))
        node_perm = tuple(ordered[i] for i in perm)
    else:
        raise ValueError(
            f"perm {perm} is neither a rearrangement of group {group} "
            f"nor of range({n})")
    return program.replace(perm=node_perm)


def chunk(program: Program, k: int) -> Program:
    """Split the payload into ``k`` serialized pipeline pieces.

    Execution model (shared with the plan compiler's scoring): the full
    schedule runs k times back-to-back at 1/k payload — captured as
    ``chunk_factor`` so the base rounds stay shared;
    ``Program.to_flows()`` materializes the repetition.
    """
    if k < 1:
        raise ValueError(f"chunk factor must be >= 1, got {k}")
    if k == 1:
        return program
    return program.replace(chunk_factor=program.chunk_factor * k)


def _participants(rnd) -> frozenset:
    return frozenset(e for f in rnd for e in (f.src, f.dst))


def fuse_rounds(program: Program, verify: bool = True) -> Tuple[Program, int]:
    """Merge adjacent rounds whose participant sets are disjoint.

    A rank absent from round i can neither produce data round i+1
    forwards nor observe its barrier, so dropping the barrier between
    two participant-disjoint rounds preserves program semantics (the
    flows now contend for links, which the executors price faithfully).
    Disjointness is over *ranks*: two instructions that share only a
    chunk id carry unrelated per-rank state entries and fuse safely
    (the reference pins this in its analysis tests).

    With ``verify`` (the default) the fused program is re-checked with
    the static dependency analysis; a fusion that manufactured an
    intra-round race or missing-data error raises
    :class:`repro_torch.analysis.VerificationError` instead of shipping.
    Returns ``(program, n_fused)``.
    """
    fused = []
    n_fused = 0
    for rnd in program.rounds:
        if fused and _participants(fused[-1]).isdisjoint(_participants(rnd)):
            fused[-1] = fused[-1] + tuple(rnd)
            n_fused += 1
        else:
            fused.append(tuple(rnd))
    if not n_fused:
        return program, 0
    out = program.replace(rounds=tuple(fused))
    if verify:
        # lazy: repro_torch.analysis imports this package's IR at module scope
        from repro_torch.analysis.deps import require_acyclic
        require_acyclic(out)
    return out, n_fused
