"""Algorithm builders: ``CollectiveOp`` → typed ``Program``.

A copy of ``repro.collective.builders``: the eight registered algorithms
compile a :class:`~repro_torch.collective.ir.CollectiveOp` into a
:class:`~repro_torch.collective.ir.Program` in identity rank order — the
rank permutation is applied afterwards by the
:func:`repro_torch.collective.passes.apply_permutation` rewrite pass, so
no builder threads ``perm`` through its schedule construction.  Each
program carries reduce/copy semantics and chunk ids that let
:func:`repro_torch.collective.ir.validate` prove its postcondition; the
tests hold every program to the reference's, round for round.

Registry contract: :func:`get_builder` raises an actionable
``ValueError`` naming every registered builder on unknown names (no
bare ``KeyError``), and :func:`candidates` reproduces the plan
compiler's feasibility gating (power-of-two algorithms only on
power-of-two groups; bcube prefers base 4 when the group is a power of
4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.schedule import _require_power_of_base, _require_power_of_two

from .ir import KINDS, CollectiveOp, FlowInstr, Program, kind_from_op

__all__ = [
    "AlgorithmBuilder",
    "register_builder",
    "get_builder",
    "registered_builders",
    "candidates",
    "compile_op",
]

Round = Tuple[FlowInstr, ...]


@dataclasses.dataclass(frozen=True)
class AlgorithmBuilder:
    """One registered collective algorithm.

    ``build(op, **kwargs)`` returns the identity-order :class:`Program`;
    ``feasible(n)`` gates group sizes (mirrors the ValueError contracts
    of the legacy builders); ``candidate_kwargs(n)`` enumerates the
    kwargs variants the plan compiler should consider (e.g. the bcube
    base).
    """

    name: str
    kinds: Tuple[str, ...]              # CollectiveOp kinds it compiles
    cost_model: str                     # analytic CostModel name
    build_fn: Callable[..., Tuple]      # (op, **kw) -> round/semantic data
    #: n=1 is a legal degenerate group (single-device meshes plan empty
    #: programs), matching the legacy builders' behavior
    feasible_fn: Callable[[int], bool] = lambda n: n >= 1
    kwargs_fn: Callable[[int], List[Dict[str, int]]] = lambda n: [{}]

    def feasible(self, n: int) -> bool:
        return bool(self.feasible_fn(n))

    def candidate_kwargs(self, n: int) -> List[Dict[str, int]]:
        return self.kwargs_fn(n)

    def build(self, op: CollectiveOp, **kwargs) -> Program:
        if op.kind not in self.kinds:
            raise ValueError(
                f"builder {self.name!r} compiles {self.kinds}, "
                f"not {op.kind!r}")
        rounds, n_chunks, chunk_bytes, init, post = self.build_fn(
            op, **kwargs)
        return Program(
            op=op,
            algorithm=self.name,
            algo_kwargs=tuple(sorted((k, int(v)) for k, v in kwargs.items())),
            rounds=tuple(tuple(r) for r in rounds),
            perm=op.group,                       # identity rank order
            n_chunks=n_chunks,
            chunk_bytes=chunk_bytes,
            init=init,
            postcondition=post,
            cost_model=self.cost_model,
        )


_REGISTRY: Dict[str, AlgorithmBuilder] = {}


def register_builder(builder: AlgorithmBuilder) -> AlgorithmBuilder:
    """Register (or replace) a builder under ``builder.name``."""
    _REGISTRY[builder.name] = builder
    return builder


def registered_builders() -> Tuple[str, ...]:
    """Registered builder names, in registration order."""
    return tuple(_REGISTRY)


def get_builder(name: str) -> AlgorithmBuilder:
    """Builder by name; unknown names raise an actionable ValueError."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collective algorithm {name!r}; registered builders: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def candidates(kind: str, n: int) -> List[Tuple[str, Dict[str, int]]]:
    """Feasible ``(builder name, kwargs)`` pairs for ``kind`` at size n.

    Accepts either an IR kind (``allreduce``) or a plan-compiler op
    string (``all-reduce``).
    """
    if kind not in KINDS:
        kind = kind_from_op(kind)
    out: List[Tuple[str, Dict[str, int]]] = []
    for name, b in _REGISTRY.items():
        if kind in b.kinds and b.feasible(n):
            out.extend((name, kw) for kw in b.candidate_kwargs(n))
    return out


def compile_op(op: CollectiveOp, algorithm: str, **kwargs) -> Program:
    """Compile ``op`` with the named registered builder."""
    return get_builder(algorithm).build(op, **kwargs)


# ---------------------------------------------------------------------------
# schedule constructions (identity rank space, chunk-annotated)
# ---------------------------------------------------------------------------

def _is_pow2(n: int) -> bool:
    return n >= 2 and n & (n - 1) == 0


def _is_pow(n: int, base: int) -> bool:
    m = 1
    while m < n:
        m *= base
    return m == n and n >= base


def _ring_chunked_allreduce(op: CollectiveOp):
    """Bandwidth-optimal ring: RS lap then AG lap, n chunks of S/n.

    RS step s: rank i forwards partial chunk (i - s) mod n; AG step s:
    rank i forwards complete chunk (i + 1 - s) mod n.  Same 2(n-1)
    rounds of n S/n flows as the legacy ``ring_allreduce_chunked``.
    """
    n = op.n
    cb = op.size_bytes / n
    rounds: List[Round] = []
    for s in range(n - 1):                       # reduce-scatter lap
        rounds.append(tuple(
            FlowInstr(i, (i + 1) % n, cb, "reduce", ((i - s) % n,))
            for i in range(n)))
    for s in range(n - 1):                       # all-gather lap
        rounds.append(tuple(
            FlowInstr(i, (i + 1) % n, cb, "copy", ((i + 1 - s) % n,))
            for i in range(n)))
    return rounds, n, cb, "replicated", "allreduce"


def _ring_sequential_allreduce(op: CollectiveOp):
    """Naive ring: the full buffer walks 0→n-1 twice, one hop per round.

    This is the paper's C_r = Σ c_{i,i-1}(S) *regime model*: the second
    lap re-walks the same hop sequence (as the legacy builder does)
    carrying the circulating partial sums — both laps are ``reduce``
    flows, which keeps the contributor-set semantics monotone — so the
    provable postcondition is a rooted ``reduce`` (rank n-1 holds the
    full result), not a full allreduce.
    """
    n = op.n
    rounds: List[Round] = []
    for _lap in range(2):
        for r in range(n - 1):
            rounds.append(
                (FlowInstr(r, r + 1, op.size_bytes, "reduce", (0,)),))
    return rounds, 1, op.size_bytes, "replicated", "reduce"


def _hd_chunks(j: int, bit: int, n: int, toward: int) -> Tuple[int, ...]:
    """Chunk ids rank j exchanges at ``bit``: low bits match j, bit
    ``bit`` equals ``toward``'s, higher bits free."""
    low_mask = (1 << bit) - 1
    out = []
    for c in range(n):
        if (c & low_mask) == (j & low_mask) and \
                ((c >> bit) & 1) == ((toward >> bit) & 1):
            out.append(c)
    return tuple(out)


def _halving_doubling_allreduce(op: CollectiveOp):
    """Recursive vector-halving distance-doubling RS + mirrored AG."""
    n = op.n
    _require_power_of_two(n, "halving_doubling")
    log_n = int(np.log2(n))
    cb = op.size_bytes / n
    rounds: List[Round] = []
    for i in range(log_n):                       # reduce-scatter
        flows = []
        for j in range(n):
            partner = j ^ (1 << i)
            sent = _hd_chunks(j, i, n, partner)
            flows.append(FlowInstr(j, partner, cb * len(sent), "reduce", sent))
        rounds.append(tuple(flows))
    for i in reversed(range(log_n)):             # all-gather mirror
        flows = []
        for j in range(n):
            partner = j ^ (1 << i)
            # j's complete chunks agree with j on bits 0..i
            mask = (1 << (i + 1)) - 1
            sent = tuple(c for c in range(n) if (c & mask) == (j & mask))
            flows.append(FlowInstr(j, partner, cb * len(sent), "copy", sent))
        rounds.append(tuple(flows))
    return rounds, n, cb, "replicated", "allreduce"


def _balanced_tree_edges(n: int) -> List[Tuple[int, int, int]]:
    """(parent, child, depth) of the balanced tree over [0, n-1]."""
    out: List[Tuple[int, int, int]] = []

    def rec(lo: int, hi: int, depth: int) -> int:
        mid = (lo + hi) // 2
        if lo <= mid - 1:
            c = rec(lo, mid - 1, depth + 1)
            out.append((mid, c, depth))
        if mid + 1 <= hi:
            c = rec(mid + 1, hi, depth + 1)
            out.append((mid, c, depth))
        return mid

    rec(0, n - 1, 0)
    return out


def _double_binary_tree_allreduce(op: CollectiveOp):
    """Two complementary trees, each reducing+broadcasting one S/2 chunk."""
    n = op.n
    half = op.size_bytes / 2.0
    edges = _balanced_tree_edges(n)
    max_depth = max((d for _, _, d in edges), default=0)
    trees = [
        [((p - shift) % n, (c - shift) % n, d) for p, c, d in edges]
        for shift in (0, 1)
    ]
    rounds: List[Round] = []
    for d in range(max_depth, -1, -1):           # reduce: deepest first
        flows = [FlowInstr(c, p, half, "reduce", (t,))
                 for t, tree in enumerate(trees)
                 for p, c, dd in tree if dd == d]
        if flows:
            rounds.append(tuple(flows))
    for d in range(0, max_depth + 1):            # broadcast: root out
        flows = [FlowInstr(p, c, half, "copy", (t,))
                 for t, tree in enumerate(trees)
                 for p, c, dd in tree if dd == d]
        if flows:
            rounds.append(tuple(flows))
    return rounds, 2, half, "replicated", "allreduce"


def _bcube_allreduce(op: CollectiveOp, base: int = 4):
    """BCube digit rounds: k = log_b(n) rounds of (b-1)-peer exchanges.

    Like the legacy builder (and Gloo's cost model here), this is the
    recursive reduce-scatter phase — after round k-1 every rank holds
    its own S/n chunk fully reduced — so the provable postcondition is
    ``reduce_scatter``.
    """
    n = op.n
    n_rounds = _require_power_of_base(n, base, "bcube")
    cb = op.size_bytes / n
    rounds: List[Round] = []
    for i in range(n_rounds):
        stride = base ** i
        flows = []
        for j in range(n):
            digit = (j // stride) % base
            for k in range(1, base):
                p = j + (((digit + k) % base) - digit) * stride
                # chunks: digits 0..i-1 match j, digit i matches peer p
                sent = tuple(
                    c for c in range(n)
                    if all((c // base ** d) % base == (j // base ** d) % base
                           for d in range(i))
                    and (c // stride) % base == (p // stride) % base)
                flows.append(FlowInstr(j, p, cb * len(sent), "reduce", sent))
        rounds.append(tuple(flows))
    return rounds, n, cb, "replicated", "reduce_scatter"


def _ring_gather_family(op: CollectiveOp):
    """One-lap chunked ring: AG forwards complete chunks; RS is the
    mirrored reduce lap (identical flow structure, so both price the
    same — the legacy compiler's convention)."""
    n = op.n
    cb = op.size_bytes / n
    rounds: List[Round] = []
    if op.kind == "reduce_scatter":
        for s in range(n - 1):
            rounds.append(tuple(
                FlowInstr(i, (i + 1) % n, cb, "reduce", ((i - s - 1) % n,))
                for i in range(n)))
        return rounds, n, cb, "replicated", "reduce_scatter"
    for s in range(n - 1):
        rounds.append(tuple(
            FlowInstr(i, (i + 1) % n, cb, "copy", ((i - s) % n,))
            for i in range(n)))
    return rounds, n, cb, "sharded", "all_gather"


def _recursive_doubling_family(op: CollectiveOp):
    """Recursive doubling AG (payload doubles) / recursive halving RS
    (payload halves): mirrored round orders, identical (pairs, size)
    multisets, so simulated cost matches the legacy AG schedule."""
    n = op.n
    _require_power_of_two(n, "recursive_doubling")
    log_n = int(np.log2(n))
    cb = op.size_bytes / n
    rounds: List[Round] = []
    if op.kind == "reduce_scatter":
        for r in range(log_n):
            bit = log_n - 1 - r
            flows = []
            for j in range(n):
                partner = j ^ (1 << bit)
                high_mask = ~((1 << (bit + 1)) - 1)
                sent = tuple(
                    c for c in range(n)
                    if (c & high_mask) == (j & high_mask)
                    and ((c >> bit) & 1) == ((partner >> bit) & 1))
                flows.append(
                    FlowInstr(j, partner, cb * len(sent), "reduce", sent))
            rounds.append(tuple(flows))
        return rounds, n, cb, "replicated", "reduce_scatter"
    for i in range(log_n):
        flows = []
        for j in range(n):
            partner = j ^ (1 << i)
            # j holds chunks agreeing with it on bits i..log-1
            mask = ~((1 << i) - 1)
            sent = tuple(c for c in range(n) if (c & mask) == (j & mask))
            flows.append(FlowInstr(j, partner, cb * len(sent), "copy", sent))
        rounds.append(tuple(flows))
    return rounds, n, cb, "sharded", "all_gather"


def _all_to_all(op: CollectiveOp):
    """Shift-scheduled all-to-all: round k sends piece (j → j+k)."""
    n = op.n
    cb = op.size_bytes / n
    rounds: List[Round] = []
    for k in range(1, n):
        rounds.append(tuple(
            FlowInstr(j, (j + k) % n, cb, "copy", (j * n + (j + k) % n,))
            for j in range(n)))
    return rounds, n * n, cb, "addressed", "all_to_all"


# ---------------------------------------------------------------------------
# registration (order = the plan compiler's candidate preference order)
# ---------------------------------------------------------------------------

register_builder(AlgorithmBuilder(
    name="ring", kinds=("allreduce",), cost_model="ring",
    build_fn=_ring_chunked_allreduce))
register_builder(AlgorithmBuilder(
    name="ring_sequential", kinds=("allreduce",), cost_model="ring",
    build_fn=_ring_sequential_allreduce))
register_builder(AlgorithmBuilder(
    name="double_binary_tree", kinds=("allreduce",),
    cost_model="double_binary_tree",
    build_fn=_double_binary_tree_allreduce))
register_builder(AlgorithmBuilder(
    name="halving_doubling", kinds=("allreduce",),
    cost_model="halving_doubling",
    build_fn=_halving_doubling_allreduce, feasible_fn=_is_pow2))
register_builder(AlgorithmBuilder(
    name="bcube", kinds=("allreduce",), cost_model="bcube",
    build_fn=_bcube_allreduce, feasible_fn=_is_pow2,
    kwargs_fn=lambda n: [{"base": 4 if _is_pow(n, 4) else 2}]))
register_builder(AlgorithmBuilder(
    name="ring_all_gather", kinds=("all_gather", "reduce_scatter"),
    cost_model="ring", build_fn=_ring_gather_family))
register_builder(AlgorithmBuilder(
    name="recursive_doubling", kinds=("all_gather", "reduce_scatter"),
    cost_model="halving_doubling",
    build_fn=_recursive_doubling_family, feasible_fn=_is_pow2))
register_builder(AlgorithmBuilder(
    name="all_to_all", kinds=("all_to_all",), cost_model="all_to_all",
    build_fn=_all_to_all))
