"""Rank-order solvers (paper §IV-C).

The paper minimizes C_O over the N! permutations with a two-stage process:

1. **stochastic search** — simulated annealing with "standard heuristics
   (e.g., permuting a random sub-array, permuting random pairs) for
   obtaining neighboring states and a timeout";
2. **solver refinement** — feed the SA incumbent C0 to an SMT solver as
   the constraint ``C_O < C0`` and let it tighten the bound.

Stage 1 is reproduced faithfully (:func:`solve_sa`, including the paper's
neighborhood moves).  Stage 2's Z3 is unavailable offline, so we
substitute deterministic refiners with the same contract (take the SA
incumbent, return something no worse):

* ring objectives are closed-tour TSPs — :func:`two_opt` / :func:`or_opt`
  with O(1) delta evaluation, and exact :func:`held_karp` for N <= 12;
* other objectives get a best-improvement pairwise-swap hill climb.

Beyond the paper, :func:`solve` also runs multi-chain SA with batched
vectorized cost evaluation (one numpy gather evaluates all chains), and a
greedy nearest-neighbor construction for ring inits.

Engine notes (see DESIGN.md §3): the SA hot path is fully vectorized —
:func:`_propose` generates one neighborhood move per chain with a handful
of numpy ops regardless of chain count (position-remap gathers and
argsort-key tricks), and for symmetric ring objectives each move carries
its changed-edge list so acceptance uses O(K) edge deltas
(:func:`_edge_delta`) instead of a full re-evaluation.  The seed
implementations are retained as ``engine="reference"``
(:func:`_propose_reference`, :func:`_or_opt_reference`) for equivalence
tests.  A copy of ``repro.core.solver``.  ``backend="jax"`` (the
reference's spelling) routes full ring evaluations through the batched
torch evaluator of :mod:`repro_torch.kernels.solver_eval`, on ``device``
(``cuda`` unless the caller passes ``"cpu"``); any other backend than
``"numpy"`` or ``"jax"`` raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from .cost_models import CostModel, RingCost

__all__ = [
    "SolveResult",
    "solve",
    "solve_sa",
    "solve_worst",
    "greedy_ring",
    "two_opt",
    "or_opt",
    "held_karp",
    "exhaustive",
    "swap_hill_climb",
]


@dataclasses.dataclass
class SolveResult:
    perm: np.ndarray
    cost: float
    trace: List[Tuple[str, int, float]]
    wall_s: float
    #: final states of the best few SA chains (vectorized engine only);
    #: stage-2 refiners use them as extra hill-climb starts
    pool: Optional[np.ndarray] = None

    def improvement_over(self, baseline_cost: float) -> float:
        return baseline_cost / max(self.cost, 1e-30)


# ---------------------------------------------------------------------------
# Constructive + exact
# ---------------------------------------------------------------------------

def greedy_ring(c: np.ndarray, start: int = 0) -> np.ndarray:
    """Nearest-neighbor tour construction on cost matrix ``c``."""
    n = c.shape[0]
    unvisited = set(range(n))
    unvisited.remove(start)
    perm = [start]
    cur = start
    while unvisited:
        nxt = min(unvisited, key=lambda j: c[cur, j])
        unvisited.remove(nxt)
        perm.append(nxt)
        cur = nxt
    return np.asarray(perm, dtype=np.int64)


def held_karp(c: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact closed-tour TSP via Held–Karp DP.  O(2^N * N^2); N <= ~13."""
    n = c.shape[0]
    assert n <= 13, "Held-Karp limited to N <= 13"
    full = 1 << (n - 1)  # subsets of {1..n-1}; city 0 fixed as start
    INF = np.inf
    dp = np.full((full, n - 1), INF)
    parent = np.full((full, n - 1), -1, dtype=np.int64)
    for j in range(n - 1):
        dp[1 << j, j] = c[0, j + 1]
    for mask in range(full):
        for j in range(n - 1):
            if not mask & (1 << j) or dp[mask, j] == INF:
                continue
            base = dp[mask, j]
            for k in range(n - 1):
                if mask & (1 << k):
                    continue
                nm = mask | (1 << k)
                cand = base + c[j + 1, k + 1]
                if cand < dp[nm, k]:
                    dp[nm, k] = cand
                    parent[nm, k] = j
    mask = full - 1
    costs = dp[mask] + c[1:, 0]
    j = int(np.argmin(costs))
    best = float(costs[j])
    tour = [j + 1]
    while parent[mask, j] >= 0:
        pj = int(parent[mask, j])
        mask ^= 1 << j
        j = pj
        tour.append(j + 1)
    tour.append(0)
    tour.reverse()
    return np.asarray(tour, dtype=np.int64), best


def exhaustive(cost_model: CostModel) -> Tuple[np.ndarray, float]:
    """Brute force over all N! permutations (N <= 8), batched eval."""
    n = cost_model.n
    assert n <= 8, "exhaustive limited to N <= 8"
    perms = np.asarray(list(itertools.permutations(range(n))), dtype=np.int64)
    costs = np.concatenate(
        [cost_model.cost_batch(perms[i : i + 8192]) for i in range(0, len(perms), 8192)]
    )
    k = int(np.argmin(costs))
    return perms[k].copy(), float(costs[k])


# ---------------------------------------------------------------------------
# Ring-specific local search (stage-2 refinement; TSP moves)
# ---------------------------------------------------------------------------

def _tour_cost(c: np.ndarray, perm: np.ndarray) -> float:
    return float(c[perm, np.roll(perm, 1)].sum())


def _apply_non_overlapping(perm: np.ndarray, moves, deltas) -> bool:
    """Greedily apply best-first non-overlapping improving reversals.

    ``moves`` is a sequence of (i, j) position pairs with i < j, sorted by
    delta; disjoint position intervals i..j+1 keep every pre-computed
    delta exact.  Returns True if any move was applied.
    """
    n = len(perm)
    occupied = np.zeros(n, dtype=bool)
    covered = 0
    applied = False
    for (i, j), d in zip(moves, deltas):
        if d >= -1e-15 or covered > n - 4:
            break
        wrap = j == n - 1              # span i..j+1 aliases position 0
        if occupied[i : j + 2].any() or (wrap and occupied[0]):
            continue
        occupied[i : j + 2] = True
        if wrap:
            occupied[0] = True
        covered += j + 2 - i
        perm[i + 1 : j + 1] = perm[i + 1 : j + 1][::-1]
        applied = True
    return applied


def two_opt(c: np.ndarray, perm: np.ndarray, max_sweeps: int = 200,
            neighbors: int = 12) -> np.ndarray:
    """Vectorized 2-opt on a closed tour, batched acceptance per sweep.

    Reversing the segment (i+1 .. j) replaces edges (i,i+1),(j,j+1) with
    (i,j),(i+1,j+1); for symmetric c the delta needs only those 4 edges.
    Each sweep evaluates candidate deltas in bulk, then greedily applies
    a best-first maximal set of *non-overlapping* improving reversals
    (disjoint position intervals keep every applied delta exact), so one
    sweep does the work of many single-move sweeps.

    For large N the sweeps run on a K-nearest-neighbor candidate list
    (a move is only ever improving if at least one created edge is
    short, so candidates pair each city with its K cheapest partners —
    O(N*K) per sweep instead of O(N^2)); full dense sweeps then verify
    convergence, so the fixpoint is a true full-2-opt local optimum.
    """
    perm = perm.copy()
    n = len(perm)
    if n < 4:
        return perm
    cand_k = min(128, (n * (n - 1)) // 2)

    def dense_sweep() -> bool:
        p = perm
        nxt = np.roll(p, -1)              # successor city of each position
        d_cur = c[p, nxt]                 # [n] current edge costs
        # cand[i, j] = c[p_i, p_j] + c[p_i+1, p_j+1] - d_i - d_j  (i < j);
        # cross2[i, j] = cross1[i+1, j+1] cyclically, so one gather + roll
        cross1 = c[np.ix_(p, p)]
        delta = cross1 + np.roll(cross1, (-1, -1), axis=(0, 1)) \
            - d_cur[:, None] - d_cur[None, :]
        # mask the no-op "reversals": i == j and adjacent (j == i+1 / wrap)
        np.fill_diagonal(delta, np.inf)
        flat = delta.ravel()
        flat[1 :: n + 1] = np.inf          # j == i + 1
        flat[n :: n + 1] = np.inf          # i == j + 1
        delta[0, n - 1] = delta[n - 1, 0] = np.inf
        # best-first top-k improving candidates (delta is symmetric; the
        # apply step canonicalizes i < j and dedups via the overlap check)
        top = np.argpartition(flat, cand_k - 1)[:cand_k]
        top = top[np.argsort(flat[top])]
        ij = [tuple(sorted(divmod(int(t), n))) for t in top]
        return _apply_non_overlapping(perm, ij, flat[top])

    use_knn = n >= 128 and neighbors > 0
    if use_knn:
        K = min(neighbors, n - 1)
        cc = c + np.where(np.eye(n, dtype=bool), np.inf, 0.0)
        knn = np.argpartition(cc, K - 1, axis=1)[:, :K]    # [n, K] node ids
        cnn = np.take_along_axis(c, knn, axis=1)           # static edge costs
        pos_of = np.empty(n, dtype=np.int64)

    def knn_sweep() -> bool:
        p = perm
        pos_of[p] = np.arange(n)
        nxt = np.roll(p, -1)
        d_cur = c[p, nxt]
        J = pos_of[knn[p]]                                 # [n, K] partner pos
        delta = cnn[p] + c[nxt[:, None], nxt[J]] \
            - d_cur[:, None] - d_cur[J]
        flat = delta.ravel()
        kk = min(cand_k, flat.size)
        top = np.argpartition(flat, kk - 1)[:kk]
        top = top[np.argsort(flat[top])]
        ij, ds = [], []
        for t in top:
            d = flat[t]
            if d >= -1e-15:
                break
            i, kcol = divmod(int(t), K)
            j = int(J[i, kcol])
            if i > j:
                i, j = j, i
            if j - i <= 1 or (i == 0 and j == n - 1):      # no-op moves
                continue
            ij.append((i, j))
            ds.append(d)
        return _apply_non_overlapping(perm, ij, ds) if ij else False

    knn_phase = use_knn
    for _ in range(max_sweeps):
        if knn_phase:
            if not knn_sweep():
                knn_phase = False      # verify convergence with dense sweeps
            continue
        if not dense_sweep():
            break
        knn_phase = use_knn
    return perm


def _two_opt_reference(c: np.ndarray, perm: np.ndarray, max_sweeps: int = 200) -> np.ndarray:
    """Seed 2-opt (one best-improvement reversal per sweep), kept verbatim
    as the ``engine="reference"`` stage-2 baseline."""
    perm = perm.copy()
    n = len(perm)
    for _ in range(max_sweeps):
        p = perm
        nxt = np.roll(p, -1)
        d_cur = c[p, nxt]
        cross1 = c[p[:, None], p[None, :]]
        cross2 = c[nxt[:, None], nxt[None, :]]
        delta = cross1 + cross2 - d_cur[:, None] - d_cur[None, :]
        iu = np.triu_indices(n, k=1)
        mask = (iu[1] - iu[0] == 1) | ((iu[0] == 0) & (iu[1] == n - 1))
        vals = delta[iu]
        vals[mask] = np.inf
        k = int(np.argmin(vals))
        if vals[k] >= -1e-15:
            break
        i, j = int(iu[0][k]), int(iu[1][k])
        perm[i + 1 : j + 1] = perm[i + 1 : j + 1][::-1]
    return perm


def or_opt(c: np.ndarray, perm: np.ndarray, seg_lens=(1, 2, 3),
           max_sweeps: Optional[int] = None) -> np.ndarray:
    """Or-opt: relocate short segments to better positions (best-improve).

    Vectorized: each sweep evaluates every (segment start, segment length,
    insertion slot) relocation delta with three [n, n] gathers per length,
    then greedily applies a best-first set of *non-overlapping* improving
    relocations — a relocation only permutes positions inside the
    interval spanned by its segment and insertion slot, so moves with
    disjoint intervals keep each other's pre-computed deltas and position
    indices exact (the same argument as ``two_opt``'s batched
    acceptance).  One sweep therefore applies O(n / interval) moves and
    the fixpoint is reached within ``max_sweeps`` recomputations even at
    large N.  Handles asymmetric cost matrices (directed edge costs
    throughout).

    ``max_sweeps=None`` (default) budgets ``max(50, n)`` sweeps — a
    relocation's interval spans segment-to-slot, so overlap rejection can
    cap a sweep at a handful of applied moves and a cold start needs
    O(n) sweeps to reach the fixpoint.  An explicit ``max_sweeps`` is
    respected as a hard cap for callers bounding runtime.
    """
    perm = np.asarray(perm, dtype=np.int64).copy()
    n = len(perm)
    if n < 4:
        return perm
    pos = np.arange(n)
    top_k = 64
    if max_sweeps is None:
        max_sweeps = max(50, n)
    for _ in range(max_sweeps):
        p = perm
        pprev = np.roll(p, 1)            # pprev[k] = p[k-1]
        dcur = c[pprev, p]               # [n] cost of edge k
        cand_i: list = []
        cand_L: list = []
        cand_k: list = []
        cand_d: list = []
        for L in seg_lens:
            if L >= n - 1:
                continue
            i = pos[: n - L + 1]         # segment start (no wrap, as seed)
            j = i + L - 1
            s0, s1 = p[i], p[j]
            prev_node = p[(i - 1) % n]
            next_node = p[(j + 1) % n]
            gain = c[prev_node, s0] + c[s1, next_node] - c[prev_node, next_node]
            # delta[ii, k]: move segment ii into the slot at edge k
            add = c[np.ix_(pprev, s0)].T + c[np.ix_(s1, p)] - dcur[None, :]
            delta = add - gain[:, None]
            # slots at edges destroyed by the removal are invalid
            km = (pos[None, :] - i[:, None]) % n
            delta[km <= L] = np.inf
            flat = delta.ravel()
            top = np.argpartition(flat, min(top_k, flat.size - 1))[:top_k]
            good = top[flat[top] < -1e-15]
            if good.size:
                ii, kk = np.divmod(good, n)
                cand_i.append(i[ii])
                cand_L.append(np.full(good.size, L))
                cand_k.append(kk)
                cand_d.append(flat[good])
        if not cand_d:
            break
        d = np.concatenate(cand_d)
        ci = np.concatenate(cand_i)
        cL = np.concatenate(cand_L)
        ck = np.concatenate(cand_k)
        occupied = np.zeros(n, dtype=bool)
        applied = False
        for t in np.argsort(d):
            i, L, k = int(ci[t]), int(cL[t]), int(ck[t])
            # positions/edges the move may change: the segment, the slot,
            # everything shifted between them, plus both boundary edges
            span = np.arange(min(i, k) - 1, max(i + L, k) + 1) % n
            if occupied[span].any():
                continue
            occupied[span] = True
            seg = perm[i : i + L].copy()
            rest = np.concatenate([perm[:i], perm[i + L :]])
            slot = k if k < i else k - L
            perm = np.concatenate([rest[:slot], seg, rest[slot:]])
            applied = True
        if not applied:
            break
    return perm


def _or_opt_reference(c: np.ndarray, perm: np.ndarray, seg_lens=(1, 2, 3),
                      max_sweeps: int = 50) -> np.ndarray:
    """Seed or-opt (first-improve, per-candidate Python loops).

    Kept verbatim as the ``engine="reference"`` stage-2 baseline for the
    equivalence property tests and the scaling benchmark.
    """
    perm = list(perm)
    n = len(perm)

    def edge(a: int, b: int) -> float:
        return float(c[perm[a % n], perm[b % n]])

    improved = True
    sweeps = 0
    while improved and sweeps < max_sweeps:
        improved = False
        sweeps += 1
        for L in seg_lens:
            for i in range(n):
                j = i + L - 1
                if j >= n:
                    continue
                gain_remove = edge(i - 1, i) + edge(j, j + 1) - edge(i - 1, j + 1)
                if gain_remove <= 1e-15:
                    continue
                seg = perm[i : j + 1]
                rest = perm[:i] + perm[j + 1 :]
                best_pos, best_add = None, np.inf
                m = len(rest)
                for k in range(m):
                    a, b = rest[k - 1], rest[k % m]
                    add = float(c[a, seg[0]] + c[seg[-1], b] - c[a, b])
                    if add < best_add:
                        best_add, best_pos = add, k
                if best_add < gain_remove - 1e-15:
                    perm = rest[:best_pos] + seg + rest[best_pos:]
                    improved = True
    return np.asarray(perm, dtype=np.int64)


def swap_hill_climb(cost_model: CostModel, perm: np.ndarray, max_sweeps: int = 30) -> np.ndarray:
    """Generic stage-2 refiner: best pairwise swap until no improvement.

    Batched: each sweep evaluates all N(N-1)/2 swap neighbors in chunks
    with ``cost_batch``.
    """
    perm = perm.copy()
    n = len(perm)
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)])
    cur = cost_model.cost(perm)
    for _ in range(max_sweeps):
        cands = np.tile(perm, (len(pairs), 1))
        rows = np.arange(len(pairs))
        a = cands[rows, pairs[:, 0]].copy()
        cands[rows, pairs[:, 0]] = cands[rows, pairs[:, 1]]
        cands[rows, pairs[:, 1]] = a
        costs = np.concatenate(
            [cost_model.cost_batch(cands[i : i + 4096]) for i in range(0, len(cands), 4096)]
        )
        k = int(np.argmin(costs))
        if costs[k] >= cur - 1e-15:
            break
        perm = cands[k]
        cur = float(costs[k])
    return perm


# ---------------------------------------------------------------------------
# Simulated annealing (stage-1, paper-faithful moves, multi-chain batched)
# ---------------------------------------------------------------------------

#: Per-move changed-edge slots (pair swap 4, reversal 2, window shuffle
#: <= 7, span roll 3); unused slots are padded with duplicates which the
#: delta evaluator masks after a sort.
_EDGE_SLOTS = 8


def _propose_moves(M: int, n: int, rng: np.random.Generator):
    """Generate M state-independent neighborhood moves (paper heuristics).

    * permute random pairs (swap),
    * permute a random sub-array (reversal — the 2-opt move — and a
      random shuffle of a short window),
    * segment relocation (or-opt move), expressed as a cyclic roll of a
      random span so positions outside the span are untouched and only
      three tour edges change.

    Every move is a pure position remap, so it is generated *without*
    the current permutations: ``proposal = perms[src]`` applies it.  The
    SA loop exploits this to pre-generate whole blocks of iterations in
    one vectorized shot.

    Returns ``(src, edge_new, edge_old)``: the remap [M, n] plus two
    (padded) tour-edge position lists per move — edges the move creates
    (positions in the proposal) and edges it destroys (positions in the
    input); edge ``e`` is the adjacency between positions ``e-1`` and
    ``e``.  The lists coincide for position-preserving moves but differ
    for the span roll, whose junctions land at shifted positions.  They
    enable O(K) ring-cost deltas (reversal entries assume a symmetric
    matrix; the caller gates on that).
    """
    idt = np.int16 if n < (1 << 15) else np.int32
    pos = np.arange(n, dtype=idt)
    src = np.tile(pos, (M, 1))
    edge_new = np.zeros((M, _EDGE_SLOTS), dtype=np.int32)
    edge_old = edge_new
    if n < 2:
        return src, edge_new, edge_old
    kinds = rng.integers(0, 4, size=M)

    sel = np.nonzero(kinds == 0)[0]          # --- pair swap
    if sel.size:
        ij = rng.integers(0, n, size=(sel.size, 2), dtype=idt)
        i, j = ij[:, 0], ij[:, 1]
        src[sel, i] = j
        src[sel, j] = i
        edge_new[sel, 0] = i
        edge_new[sel, 1] = (i + 1) % n
        edge_new[sel, 2] = j
        edge_new[sel, 3] = (j + 1) % n
        edge_new[sel, 4:] = i[:, None]

    sel = np.nonzero(kinds == 1)[0]          # --- sub-array reversal
    if sel.size:
        ij = np.sort(rng.integers(0, n, size=(sel.size, 2), dtype=idt), axis=1)
        i, j = ij[:, 0][:, None], ij[:, 1][:, None]
        src[sel] = np.where((pos >= i) & (pos <= j), i + j - pos, pos[None, :])
        edge_new[sel, 0] = ij[:, 0]
        edge_new[sel, 1] = (ij[:, 1] + 1) % n
        edge_new[sel, 2:] = ij[:, 0][:, None]

    sel = np.nonzero(kinds == 2)[0]          # --- short-window shuffle
    if sel.size:
        m = sel.size
        wmax = min(6, n)
        i = rng.integers(0, n, size=m, dtype=idt)
        w = rng.integers(2, wmax + 1, size=m, dtype=idt)
        ar = np.arange(wmax, dtype=idt)
        # argsort-key trick: random keys on the first w slots produce a
        # uniform permutation there; ordered keys keep the tail in place.
        keys = np.where(ar[None, :] < w[:, None],
                        rng.random((m, wmax)), 1.0 + ar[None, :])
        sigma = np.argsort(keys, axis=1)
        # widen before the add: i + ar can exceed the int16 range for
        # n within wmax of 2**15, corrupting the wrap-around window
        winpos = (i[:, None].astype(np.int32) + np.arange(wmax)) % n
        # sparse scatter: only the <= wmax window columns change per row
        flat_idx = winpos.astype(np.int64) + (sel[:, None] * n)
        src.reshape(-1)[flat_idx] = np.take_along_axis(winpos, sigma, axis=1)
        cols = np.arange(_EDGE_SLOTS, dtype=np.int32)
        edge_new[sel] = (i[:, None] + np.minimum(cols[None, :], w[:, None])) % n

    sel = np.nonzero(kinds == 3)[0]          # --- span roll (relocation)
    if sel.size and n >= 3:
        m = sel.size
        a = rng.integers(0, n - 1, size=m, dtype=idt)
        # span length capped at n-1: a full-ring roll is a pure rotation
        # (cost no-op) whose uniformly shifted edges defeat edge deltas
        s = rng.integers(2, np.minimum(n - a, n - 1) + 1, dtype=idt)
        # roll by d (or s-d) relocates a short d-element segment across
        # the span — matching the seed's 1..3-element relocation moves
        # (a roll by r in the middle of the range would displace every
        # span element, a far larger perturbation than the paper's move)
        d = rng.integers(1, np.minimum(3, s - 1) + 1, dtype=idt)
        r = np.where(rng.random(m) < 0.5, s - d, d).astype(idt)
        rel = pos[None, :] - a[:, None]
        inspan = (rel >= 0) & (rel < s[:, None])
        # (rel - r) mod s without integer division: rel - r is in [-r, s-r)
        shifted = rel - r[:, None]
        shifted += (shifted < 0) * s[:, None]
        src[sel] = np.where(inspan, a[:, None] + shifted, pos[None, :])
        # junctions land at different positions in the two frames:
        # created edges at {a, a+r, a+s}, destroyed at {a, a+s-r, a+s}
        edge_old = edge_new.copy()
        b = a + s
        edge_new[sel, 0] = a
        edge_new[sel, 1] = (a + r) % n
        edge_new[sel, 2] = b % n
        edge_new[sel, 3:] = a[:, None]
        edge_old[sel, 0] = a
        edge_old[sel, 1] = (b - r) % n
        edge_old[sel, 2] = b % n
        edge_old[sel, 3:] = a[:, None]

    return src, edge_new, edge_old


def _propose(perms: np.ndarray, rng: np.random.Generator,
             return_edges: bool = False):
    """One neighborhood move per chain, all chains at once."""
    P, n = perms.shape
    src, edge_new, edge_old = _propose_moves(P, n, rng)
    out = np.take_along_axis(perms, src, axis=1)
    return (out, edge_new, edge_old) if return_edges else out


def _propose_reference(perms: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Seed proposal kernel (per-chain Python loop), kept verbatim for
    ``engine="reference"`` baselines and equivalence tests."""
    out = perms.copy()
    P, n = perms.shape
    kinds = rng.integers(0, 4, size=P)
    for p in range(P):
        k = kinds[p]
        if k == 0:  # pair swap
            i, j = rng.integers(0, n, size=2)
            out[p, i], out[p, j] = out[p, j], out[p, i]
        elif k == 1:  # sub-array reversal
            i, j = np.sort(rng.integers(0, n, size=2))
            out[p, i : j + 1] = out[p, i : j + 1][::-1]
        elif k == 2:  # sub-array shuffle (short window)
            i = rng.integers(0, n)
            w = int(rng.integers(2, min(6, n) + 1))
            idx = (i + np.arange(w)) % n
            out[p, idx] = out[p, idx[rng.permutation(w)]]
        else:  # segment relocation
            L = int(rng.integers(1, min(4, n)))
            i = int(rng.integers(0, n - L + 1))
            seg = out[p, i : i + L].copy()
            rest = np.delete(out[p], np.s_[i : i + L])
            k2 = int(rng.integers(0, len(rest) + 1))
            out[p] = np.concatenate([rest[:k2], seg, rest[k2:]])
    return out


def _edge_sum(cmat: np.ndarray, perms: np.ndarray, edge_idx: np.ndarray) -> np.ndarray:
    """Sum of ring-edge costs ``cmat[perm[e], perm[e-1]]`` over the unique
    edges in each chain's (padded) list — duplicates are masked after an
    in-row sort.  O(P * K), independent of N."""
    n = perms.shape[1]
    es = np.sort(edge_idx, axis=1)
    dup = np.zeros(es.shape, dtype=bool)
    dup[:, 1:] = es[:, 1:] == es[:, :-1]
    prev = (es - 1) % n
    cost = cmat[np.take_along_axis(perms, es, 1), np.take_along_axis(perms, prev, 1)]
    cost[dup] = 0.0
    return cost.sum(axis=1)


def _edge_delta(cmat: np.ndarray, old: np.ndarray, new: np.ndarray,
                edge_new: np.ndarray, edge_old: np.ndarray) -> np.ndarray:
    """Ring-cost delta per chain: created-edge sum minus destroyed-edge
    sum.  The two lists coincide for position-preserving moves; the span
    roll destroys edges at positions shifted from where it creates them.
    """
    return _edge_sum(cmat, new, edge_new) - _edge_sum(cmat, old, edge_old)


def solve_sa(
    cost_model: CostModel,
    iters: int = 3000,
    chains: int = 16,
    t0: Optional[float] = None,
    t_final_frac: float = 1e-3,
    seed: int = 0,
    init: Optional[np.ndarray] = None,
    timeout_s: Optional[float] = None,
    maximize: bool = False,
    engine: str = "vectorized",
    backend: str = "numpy",
    resync_every: int = 256,
    device: Any = "cuda",
) -> SolveResult:
    """Multi-chain simulated annealing with batched cost evaluation.

    ``engine="vectorized"`` (default) proposes moves for all chains with
    vectorized numpy and, for symmetric ring objectives, scores them with
    O(K) edge deltas (full evaluations only every ``resync_every`` iters
    to cancel float drift).  ``engine="reference"`` is the seed per-chain
    loop with full re-evaluation every iteration.  ``backend="jax"``
    routes full ring evaluations through the batched evaluator of
    :mod:`repro_torch.kernels.solver_eval` on ``device``, where the
    reference routes them to its jitted one (other cost models evaluate
    in numpy, as there); without CUDA it raises unless ``device="cpu"``.
    """
    dev = _backend_device(backend, device)
    # solver wall clock stays raw: the SA hot loop checks timeout_s
    # per iteration and cannot afford a tracer call per check
    t_start = time.perf_counter()  # lint: allow(raw-perf-counter)
    rng = np.random.default_rng(seed)
    n = cost_model.n
    sign = -1.0 if maximize else 1.0

    evaluate = cost_model.cost_batch
    ring_mat = None
    if isinstance(cost_model, RingCost):
        ring_mat = _ring_matrix(cost_model)
        if dev is not None:
            from repro_torch.kernels.solver_eval import make_ring_evaluator

            evaluate = make_ring_evaluator(ring_mat, dev)
    use_delta = (
        engine == "vectorized"
        and ring_mat is not None
        and np.array_equal(ring_mat, ring_mat.T)
    )

    perms = np.stack([rng.permutation(n) for _ in range(chains)])
    if init is not None:
        perms[0] = np.asarray(init)
    costs = sign * evaluate(perms)
    best_i = int(np.argmin(costs))
    best_perm, best_cost = perms[best_i].copy(), float(costs[best_i])
    trace: List[Tuple[str, int, float]] = [("sa", 0, sign * best_cost)]

    if t0 is None:
        t0 = float(np.std(costs)) + 1e-12
    t_final = max(t0 * t_final_frac, 1e-30)

    if engine == "reference":
        for it in range(1, iters + 1):
            temp = t0 * (t_final / t0) ** (it / iters)
            proposal = _propose_reference(perms, rng)
            new_costs = sign * evaluate(proposal)
            accept = (new_costs < costs) | (
                rng.random(chains)
                < np.exp(np.clip((costs - new_costs) / temp, -60, 0))
            )
            perms[accept] = proposal[accept]
            costs[accept] = new_costs[accept]
            i = int(np.argmin(costs))
            if costs[i] < best_cost:
                best_cost = float(costs[i])
                best_perm = perms[i].copy()
                trace.append(("sa", it, sign * best_cost))
            if timeout_s is not None and \
                    time.perf_counter() - t_start > timeout_s:  # lint: allow(raw-perf-counter)
                break
    else:
        # Vectorized engine: moves are state-independent position remaps,
        # so whole blocks of iterations are pre-generated in one shot —
        # including the flattened gather indices and signed dedup weights
        # for the O(K) ring delta — and the sequential loop is one [P,32]
        # gather plus ~a dozen tiny numpy ops per iteration.
        # Pre-generate moves in blocks sized to stay cache-friendly.
        block = max(32, min(256, (1 << 22) // max(chains * n, 1)))
        K = _EDGE_SLOTS
        perms = np.ascontiguousarray(perms, dtype=np.int32)
        best_perm = best_perm.astype(np.int32)
        perms_flat = perms.reshape(-1)           # view; updated in place
        chain_off = (np.arange(chains, dtype=np.int32) * n)[:, None]
        cflat = ring_mat.reshape(-1) if use_delta else None
        np_nonzero = np.nonzero
        perf_counter = time.perf_counter  # lint: allow(raw-perf-counter)
        it = 0
        stop = False
        while it < iters and not stop:
            B = min(block, iters - it)
            M = B * chains
            src_b, e_new, e_old = _propose_moves(M, n, rng)
            u_acc = rng.random((B, chains))
            # log-space acceptance: u < exp(min(arg, 0)) == log(u) < arg
            # (improving moves have arg > 0 > log u, so they always pass)
            with np.errstate(divide="ignore"):
                log_u = np.log(u_acc)
            temps = t0 * (t_final / t0) ** (np.arange(it + 1, it + B + 1) / iters)
            neg_inv_t = (-sign / temps)
            src_b = src_b.reshape(B, chains, n)
            if use_delta:
                # per-row flat offsets into perms_flat (row r -> chain r%chains)
                moff = np.tile(chain_off.T.reshape(1, chains), (B, 1)).reshape(M, 1)
                es_n = np.sort(e_new, axis=1)
                es_o = np.sort(e_old, axis=1)
                # edge "a" side = value at position e, "b" side = position e-1;
                # the new frame reads through the move's src remap
                sflat = src_b.reshape(M, n)
                rows = (np.arange(M, dtype=np.int32) * n)[:, None]
                a_new = sflat.reshape(-1)[es_n + rows] + moff
                b_new = sflat.reshape(-1)[(es_n - 1) % n + rows] + moff
                a_old = es_o + moff
                b_old = (es_o - 1) % n + moff
                # one [.., 2, P, 2K] index tensor: a single per-iter gather
                # yields contiguous a- and b-side planes for the a*n+b fuse
                pos_ab = np.stack([
                    np.concatenate([a_new, a_old], axis=1).reshape(B, chains, 2 * K),
                    np.concatenate([b_new, b_old], axis=1).reshape(B, chains, 2 * K),
                ], axis=1)
                w_n = (es_n[:, 1:] != es_n[:, :-1])
                w_o = (es_o[:, 1:] != es_o[:, :-1])
                wsign = np.concatenate([
                    np.ones((M, 1)), w_n.astype(np.float64),
                    -np.ones((M, 1)), -w_o.astype(np.float64)], axis=1
                ).reshape(B, chains, 2 * K)
                # fold the acceptance scaling into the weights so the loop
                # computes arg = delta * (-sign/temp) with one dot product
                wsign_t = wsign * neg_inv_t[:, None, None]
                temp_back = -sign * temps            # arg -> delta
            for k in range(B):
                it += 1
                if use_delta:
                    vab = perms_flat[pos_ab[k]]              # [2, P, 2K]
                    ce = cflat[vab[0] * np.int32(n) + vab[1]]
                    arg = (ce * wsign_t[k]).sum(axis=1)      # delta * -sign/T
                    sel = np_nonzero(log_u[k] < arg)[0]
                    if sel.size:
                        perms[sel] = perms_flat[src_b[k][sel] + chain_off[sel]]
                        cs = costs[sel] + sign * (arg[sel] * temp_back[k])
                        costs[sel] = cs
                        mn = cs.min()
                        if mn < best_cost:
                            best_cost = float(mn)
                            best_perm = perms[sel[int(np.argmin(cs))]].copy()
                            trace.append(("sa", it, sign * best_cost))
                    if it % resync_every == 0:
                        costs = sign * evaluate(perms)
                else:
                    proposal = perms_flat[src_b[k] + chain_off]
                    new_costs = sign * evaluate(proposal)
                    accept = (new_costs < costs) | (
                        u_acc[k]
                        < np.exp(np.clip((costs - new_costs) / temps[k], -60, 0))
                    )
                    perms[accept] = proposal[accept]
                    costs[accept] = new_costs[accept]
                    i = int(np.argmin(costs))
                    if costs[i] < best_cost:
                        best_cost = float(costs[i])
                        best_perm = perms[i].copy()
                        trace.append(("sa", it, sign * best_cost))
                if (timeout_s is not None
                        and perf_counter() - t_start > timeout_s):
                    stop = True
                    break

    # Report the exact cost of the incumbent (the delta path accumulates
    # O(1e-15) float drift between resyncs).
    pool = None
    if engine != "reference":
        order = np.argsort(costs)[: min(3, chains)]
        pool = np.asarray(perms)[order].astype(np.int64)
    return SolveResult(
        perm=best_perm,
        cost=float(cost_model.cost(best_perm)),
        trace=trace,
        wall_s=time.perf_counter() - t_start,  # lint: allow(raw-perf-counter)
        pool=pool,
    )


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def _backend_device(backend: str, device: Any):
    """The evaluator's device for ``backend="jax"`` (resolved, so a
    missing card raises), None for ``"numpy"``; any other name raises."""
    if backend == "numpy":
        return None
    if backend == "jax":
        from repro_torch import resolve_device

        return resolve_device(device)
    raise ValueError(f"unknown solve backend {backend!r}: want 'numpy' or "
                     f"'jax' (the batched evaluator)")


def _ring_matrix(cost_model: CostModel) -> np.ndarray:
    """Effective symmetric edge-cost matrix for ring objectives."""
    if cost_model.c is not None:
        return cost_model.c
    return cost_model.lat + cost_model.size_bytes * cost_model.invbw


def solve(
    cost_model: CostModel,
    method: str = "auto",
    iters: int = 3000,
    chains: int = 16,
    seed: int = 0,
    timeout_s: Optional[float] = None,
    engine: str = "vectorized",
    backend: str = "numpy",
    device: Any = "cuda",
) -> SolveResult:
    """Full two-stage pipeline.

    ``method``:
      * ``"paper"`` — SA with the paper's moves, then stage-2 refinement
        (our Z3 substitute) seeded with the SA incumbent.
      * ``"auto"``  — additionally: exhaustive for tiny N, Held–Karp for
        small ring N, greedy+2-opt+Or-opt construction for rings; keeps
        the best of all candidates.
      * ``"sa"``    — stage-1 only.

    ``engine="reference"`` runs the seed implementation end to end (seed
    SA loop + first-improve or-opt); ``backend`` and ``device`` are
    forwarded to stage 1.
    """
    _backend_device(backend, device)
    t_start = time.perf_counter()  # lint: allow(raw-perf-counter)
    n = cost_model.n
    is_ring = isinstance(cost_model, RingCost)
    oropt = _or_opt_reference if engine == "reference" else or_opt
    twoopt = _two_opt_reference if engine == "reference" else two_opt
    candidates: List[Tuple[np.ndarray, float, str]] = []

    if method == "auto" and n <= 8:
        perm, cost = exhaustive(cost_model)
        return SolveResult(perm, cost, [("exhaustive", 0, cost)],
                           time.perf_counter() - t_start)  # lint: allow(raw-perf-counter)

    sa = solve_sa(cost_model, iters=iters, chains=chains, seed=seed,
                  timeout_s=timeout_s, engine=engine, backend=backend,
                  device=device)
    candidates.append((sa.perm, sa.cost, "sa"))
    trace = list(sa.trace)

    if method in ("paper", "auto"):
        # Stage 2: refine the incumbent (Z3-substitute, see module doc).
        if is_ring:
            c = _ring_matrix(cost_model)
            if n <= 12 and method == "auto":
                perm, cost = held_karp(c)
                candidates.append((perm, cost, "held_karp"))
            if engine == "reference":
                refined = oropt(c, twoopt(c, sa.perm))
            else:
                # alternate 2-opt / Or-opt (joint refinement), keeping the
                # best round by *model* cost: on asymmetric matrices the
                # refiners optimize the transposed tour direction (the
                # seed's convention), so a later round can regress the
                # model objective and must not overwrite an earlier win
                refined = np.asarray(sa.perm)
                best_c = cost_model.cost(refined)
                cand = refined
                for _ in range(2):
                    cand = oropt(c, twoopt(c, cand))
                    cur = cost_model.cost(cand)
                    if cur < best_c - 1e-12:
                        refined, best_c = cand, cur
                    else:
                        break
            candidates.append((refined, cost_model.cost(refined), "2opt+oropt"))
            if method == "auto":
                g = greedy_ring(c)
                g = oropt(c, twoopt(c, g))
                candidates.append((g, cost_model.cost(g), "greedy+2opt"))
        else:
            refined = swap_hill_climb(cost_model, sa.perm)
            candidates.append((refined, cost_model.cost(refined), "swap_hc"))
            # vectorized engine: also climb from the best few SA chain
            # states — different basins often beat the single incumbent
            if sa.pool is not None and n <= 128:
                for start in sa.pool:
                    r = swap_hill_climb(cost_model, np.asarray(start))
                    candidates.append((r, cost_model.cost(r), "swap_hc_pool"))

    perm, cost, tag = min(candidates, key=lambda t: t[1])
    trace.append((tag, -1, cost))
    return SolveResult(np.asarray(perm), float(cost), trace,
                       time.perf_counter() - t_start)  # lint: allow(raw-perf-counter)


def solve_worst(
    cost_model: CostModel, iters: int = 3000, chains: int = 16, seed: int = 0,
    engine: str = "vectorized",
) -> SolveResult:
    """Find a *bad* ordering (paper's speedup baseline is the worst order)."""
    return solve_sa(cost_model, iters=iters, chains=chains, seed=seed,
                    maximize=True, engine=engine)


def percentile_orders(
    cost_model: CostModel,
    best: np.ndarray,
    worst: np.ndarray,
    k: int = 10,
    pool: int = 600,
    seed: int = 0,
) -> List[np.ndarray]:
    """Rank orders spanning the solver's cost range (paper §V-B).

    The paper validates its cost model with "10 different rank orders,
    with the i-th order approximately corresponding to the 10i-th
    percentile in the range of costs found by the solver".  We rebuild
    that population with a random walk away from the best order (random
    pair swaps of increasing strength), then pick, for each of k evenly
    spaced cost targets between best and worst, the sampled order whose
    model cost is closest.
    """
    rng = np.random.default_rng(seed)
    n = cost_model.n
    samples = [np.asarray(best).copy(), np.asarray(worst).copy()]
    cur = np.asarray(best).copy()
    restart_every = max(pool // 4, 1)  # guard: pool < 4 must not div-by-zero
    for i in range(pool):
        for _ in range(1 + i * 3 // pool):
            a, b = rng.integers(0, n, size=2)
            cur[a], cur[b] = cur[b], cur[a]
        samples.append(cur.copy())
        if (i + 1) % restart_every == 0:  # restart walks from random points
            cur = rng.permutation(n)
    arr = np.stack(samples)
    costs = cost_model.cost_batch(arr)
    targets = np.linspace(costs.min(), costs.max(), k)
    picks = []
    for t in targets:
        picks.append(arr[int(np.argmin(np.abs(costs - t)))])
    return picks
