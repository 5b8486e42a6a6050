"""Cost models for collective algorithms (paper §IV-A).

Each model computes C_O(N, c, S) for a candidate rank permutation ``perm``
where ``perm[rank] = node``: the node placed at logical rank ``rank``.

Two cost parameterizations are supported:

* **paper-faithful**: a single pairwise matrix ``c[i, j]`` (latency-centric,
  paper §IV-B); rounds moving S_r != S rescale linearly.
* **exact lat/bw** (TPU adaptation): per-pair ``lat`` and ``bw`` matrices;
  a round moving S_r costs ``lat + S_r / bw`` — the alpha-beta model, so
  small log-round payloads are not over-charged for latency.

All models share one internal representation (rounds of rank-space pairs)
so scalar and *batched* (many permutations at once — used by the
stochastic solvers) evaluation is pure vectorized numpy:

* ``ring``               total = SUM over ring edges of  c(S)
* ``halving_doubling``   total = SUM over rounds of MAX over pairs of c(S_r)
* ``double_binary_tree`` total = MAX over two trees of MAX over root->leaf
                                  paths of SUM of edge costs (S/2)
* ``bcube``              total = SUM over rounds of MAX over (B-1)-peer
                                  exchanges of c(S_r)
* ``all_to_all``         (beyond paper — MoE expert parallelism) total =
                                  SUM over N-1 shifts of MAX over pairs of c(S/N)

N is assumed a power of two for halving-doubling (paper assumption); rank
arithmetic wraps mod N (paper: "allow arbitrary rank r to alias to
canonical rank (r+N) mod N").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .schedule import _require_power_of_base, _require_power_of_two

__all__ = [
    "CostModel",
    "RingCost",
    "HalvingDoublingCost",
    "DoubleBinaryTreeCost",
    "BCubeCost",
    "AllToAllCost",
    "make_cost_model",
    "COST_MODELS",
]


def _as_batch(perms: np.ndarray) -> np.ndarray:
    perms = np.asarray(perms)
    return perms[None, :] if perms.ndim == 1 else perms


@dataclasses.dataclass
class _Round:
    """One communication round: pairs of logical ranks + payload bytes."""

    pairs: np.ndarray  # [k, 2] int, rank-space
    payload: float     # bytes transferred by each pair in this round


#: Round structure depends only on (class, n, per-class extras) — never on
#: the cost matrix or message size (per-round payloads are fixed fractions
#: of ``size_bytes``, so they are cached at unit size and scaled per
#: instance).  Shared across model instances so repeated construction
#: (solver sweeps, per-group mesh costs, message-size sweeps) skips the
#: Python round-building loops and the key space stays finite.
_STRUCT_CACHE: Dict[tuple, dict] = {}

#: cost_batch processes the flattened edge tensor in slabs at most this many
#: elements (P * E) at a time, so huge schedules (all-to-all at N=1024 is
#: ~1M edges) don't allocate multi-hundred-MB intermediates.
_BATCH_SLAB_ELEMS = 1 << 24


class CostModel:
    """Base: rounds of (pairs, payload); subclasses set the aggregator."""

    name = "base"
    #: 'sum_of_max' (HD/BCube/a2a) or 'sum_of_sum' (ring); trees override.
    aggregator = "sum_of_max"

    def __init__(
        self,
        n: int,
        size_bytes: float,
        cost_matrix: Optional[np.ndarray] = None,
        *,
        lat: Optional[np.ndarray] = None,
        bw: Optional[np.ndarray] = None,
    ):
        self.n = n
        self.size_bytes = float(size_bytes)
        if lat is not None:
            assert bw is not None
            self.lat = np.asarray(lat, dtype=np.float64)
            with np.errstate(divide="ignore"):
                self.invbw = np.where(np.isinf(bw), 0.0, 1.0 / np.asarray(bw))
            self.c = None
        else:
            assert cost_matrix is not None
            assert cost_matrix.shape == (n, n), (cost_matrix.shape, n)
            self.c = np.asarray(cost_matrix, dtype=np.float64)
            self.lat = None
            self.invbw = None
        self._build_structure()

    def _structure_key(self) -> tuple:
        """Cache key for the permutation-independent round structure."""
        return (type(self).__name__, self.n) + self._structure_extras()

    def _structure_extras(self) -> tuple:
        """Per-class extra key fields (e.g. bcube base, tree mode)."""
        return ()

    def _build_structure(self) -> None:
        key = self._structure_key()
        cached = _STRUCT_CACHE.get(key)
        if cached is None:
            # Build at unit message size: per-round payloads become the
            # size-independent fractions, so one cache entry serves every
            # message size at this (class, n, extras).
            real_size = self.size_bytes
            self.size_bytes = 1.0
            try:
                unit_rounds = self._make_rounds()
            finally:
                self.size_bytes = real_size
            cached = {"rounds": unit_rounds,
                      "flat": self._flatten_rounds(unit_rounds)}
            # DBT path mode builds per-instance tensors in _make_rounds;
            # snapshot them so cache hits restore the full structure.
            for attr in ("_edge_arr", "_paths_mat"):
                if hasattr(self, attr):
                    cached[attr] = getattr(self, attr)
            _STRUCT_CACHE[key] = cached
        # Materialize real payloads (pairs arrays are shared, not copied).
        self.rounds = [_Round(pairs=r.pairs, payload=r.payload * self.size_bytes)
                       for r in cached["rounds"]]
        if cached["flat"] is None:
            self._flat = None
        else:
            a, b, frac, starts = cached["flat"]
            self._flat = (a, b, frac * self.size_bytes, starts)
        for attr in ("_edge_arr", "_paths_mat"):
            if attr in cached:
                setattr(self, attr, cached[attr])

    @staticmethod
    def _flatten_rounds(rounds: List[_Round]):
        """Concatenate all rounds into single gather-ready index tensors.

        Returns (a, b, payload, starts): flat rank indices [E], per-edge
        payload [E], and the offset of each round for segment reductions.
        """
        if not rounds:
            return None
        a = np.concatenate([r.pairs[:, 0] for r in rounds])
        b = np.concatenate([r.pairs[:, 1] for r in rounds])
        payload = np.concatenate(
            [np.full(len(r.pairs), r.payload) for r in rounds]
        )
        starts = np.cumsum([0] + [len(r.pairs) for r in rounds])[:-1]
        return a, b, payload, starts

    # -- schedule structure (rank space, permutation independent) --------
    def _make_rounds(self) -> List[_Round]:
        raise NotImplementedError

    # -- edge costs -------------------------------------------------------
    def _edge_costs(self, a: np.ndarray, b: np.ndarray, payload: float) -> np.ndarray:
        """Cost of transferring ``payload`` bytes for node pairs (a, b)."""
        if self.c is not None:
            scale = 1.0 if self.size_bytes == 0 else payload / self.size_bytes
            return self.c[a, b] * scale
        return self.lat[a, b] + payload * self.invbw[a, b]

    # -- evaluation -------------------------------------------------------
    def cost(self, perm: Sequence[int]) -> float:
        return float(self.cost_batch(np.asarray(perm)[None, :])[0])

    def cost_batch(self, perms: np.ndarray) -> np.ndarray:
        """Evaluate P permutations at once -> [P] costs.

        All rounds are evaluated with one gather over the flattened edge
        tensor followed by a per-round segment reduction — no Python loop
        over rounds (the seed implementation's per-round loop dominated
        wall clock for round-heavy schedules like all-to-all / bcube).
        """
        perms = _as_batch(perms)
        if self._flat is None:
            return np.zeros(perms.shape[0])
        fa, fb, payload, starts = self._flat
        P, E = perms.shape[0], len(fa)
        if P * E <= _BATCH_SLAB_ELEMS or len(starts) == 1:
            return self._cost_batch_slab(perms, fa, fb, payload, starts)
        # Slab along round boundaries to bound peak memory.
        bounds = list(starts) + [E]
        total = np.zeros(P)
        lo_r = 0
        per_round_edges = max(E // len(starts), 1)
        rounds_per_slab = max(_BATCH_SLAB_ELEMS // max(P * per_round_edges, 1), 1)
        while lo_r < len(starts):
            hi_r = min(lo_r + rounds_per_slab, len(starts))
            lo, hi = bounds[lo_r], bounds[hi_r]
            total += self._cost_batch_slab(
                perms, fa[lo:hi], fb[lo:hi], payload[lo:hi],
                starts[lo_r:hi_r] - lo)
            lo_r = hi_r
        return total

    def _cost_batch_slab(self, perms, fa, fb, payload, starts) -> np.ndarray:
        a = perms[:, fa]                           # [P, E] node ids
        b = perms[:, fb]
        if self.c is not None:
            edge = self.c[a, b]
            if self.size_bytes != 0:
                edge = edge * (payload / self.size_bytes)[None, :]
        else:
            edge = self.lat[a, b] + payload[None, :] * self.invbw[a, b]
        if self.aggregator == "sum_of_sum":
            return edge.sum(axis=1)
        if self.aggregator == "sum_of_max":
            return np.maximum.reduceat(edge, starts, axis=1).sum(axis=1)
        raise NotImplementedError(self.aggregator)  # pragma: no cover

    # -- introspection ----------------------------------------------------
    def critical_edges(self, perm: Sequence[int]) -> List[Tuple[int, int, float]]:
        """Edges (node_a, node_b, cost) that set each round's cost.

        Used by the dynamic re-ranker (paper §VI: find the bottleneck
        transfer on the critical path).
        """
        perm = np.asarray(perm)
        out: List[Tuple[int, int, float]] = []
        for rnd in self.rounds:
            a = perm[rnd.pairs[:, 0]]
            b = perm[rnd.pairs[:, 1]]
            edge = self._edge_costs(a, b, rnd.payload)
            if self.aggregator == "sum_of_max":
                k = int(np.argmax(edge))
                out.append((int(a[k]), int(b[k]), float(edge[k])))
            else:
                out.extend(
                    (int(a[k]), int(b[k]), float(edge[k])) for k in range(len(edge))
                )
        return out


class RingCost(CostModel):
    """C_r = sum_i c_{i, i-1}(S)  (paper §IV-A, Ring).

    This is exactly a closed-tour traveling-salesman objective over the
    symmetric cost matrix — which is why classic TSP refinements (2-opt,
    Or-opt, Held–Karp) apply; the paper's SA "segment reversal" heuristic
    is the 2-opt move.
    """

    name = "ring"
    aggregator = "sum_of_sum"

    def _make_rounds(self) -> List[_Round]:
        i = np.arange(self.n)
        pairs = np.stack([i, (i - 1) % self.n], axis=1)
        return [_Round(pairs=pairs, payload=self.size_bytes)]


class HalvingDoublingCost(CostModel):
    """C_hd = sum_rounds max_pairs c(S / 2^{i+1})  (paper §IV-A).

    Round ``i`` pairs rank j with rank j XOR 2^i (recursive halving,
    distance doubling); each round moves half the previous payload.
    """

    name = "halving_doubling"
    aggregator = "sum_of_max"

    def _make_rounds(self) -> List[_Round]:
        n = self.n
        _require_power_of_two(n, "halving_doubling")
        rounds = []
        for i in range(int(np.log2(n))):
            j = np.arange(n)
            partner = j ^ (1 << i)
            keep = j < partner
            pairs = np.stack([j[keep], partner[keep]], axis=1)
            rounds.append(_Round(pairs=pairs, payload=self.size_bytes / (2 ** (i + 1))))
        return rounds


class DoubleBinaryTreeCost(CostModel):
    """C_dbt over two complementary balanced binary trees.

    Two modes:

    * ``mode="path"`` (paper §IV-A, default): critical path —
      T(i,j,S) = max over the two subtree edges of (edge cost + subtree
      T); the mirrored tree shifts every rank by -1 mod N; each tree
      carries S/2; total = max(tree, mirror).
    * ``mode="barrier"`` (beyond paper): depth-synchronized execution —
      sum over depth rounds of the max edge cost across BOTH concurrent
      trees (reduce + broadcast phases).  Matches backends that barrier
      between tree levels; our Fig. 4 reproduction shows the paper's
      path model can mis-rank orders under such backends (see
      EXPERIMENTS.md §Fig4).

    Internally (path mode): precompute, per tree, every root->node path's
    edge list; cost(perm) = max over paths of sum of permuted edge costs
    — batched evaluation is one gather + matmul.
    """

    name = "double_binary_tree"
    aggregator = "path_max"

    def __init__(self, n, size_bytes, cost_matrix=None, *, mode: str = "path", **kw):
        self.mode = mode
        super().__init__(n, size_bytes, cost_matrix, **kw)
        if mode == "barrier":
            self.aggregator = "sum_of_max"

    def _structure_extras(self) -> tuple:
        return (self.mode,)

    def _tree_edge_list(self) -> List[tuple]:
        """(parent, child, depth) of the balanced tree over [0, n-1]."""
        out: List[tuple] = []

        def rec(lo: int, hi: int, depth: int) -> int:
            mid = (lo + hi) // 2
            if lo <= mid - 1:
                c = rec(lo, mid - 1, depth + 1)
                out.append((mid, c, depth))
            if mid + 1 <= hi:
                c = rec(mid + 1, hi, depth + 1)
                out.append((mid, c, depth))
            return mid

        rec(0, self.n - 1, 0)
        return out

    def _barrier_rounds(self) -> List[_Round]:
        edges = self._tree_edge_list()
        max_depth = max((d for _, _, d in edges), default=0)
        payload = self.size_bytes / 2.0
        rounds: List[_Round] = []
        for phase in ("reduce", "broadcast"):
            depths = range(max_depth, -1, -1) if phase == "reduce" \
                else range(0, max_depth + 1)
            for d in depths:
                pairs = []
                for shift in (0, 1):
                    for p_, c_, dd in edges:
                        if dd == d:
                            pairs.append(((p_ - shift) % self.n,
                                          (c_ - shift) % self.n))
                if pairs:
                    rounds.append(_Round(
                        pairs=np.asarray(pairs, dtype=np.int64),
                        payload=payload))
        return rounds

    def _make_rounds(self) -> List[_Round]:
        if getattr(self, "mode", "path") == "barrier":
            return self._barrier_rounds()
        out_paths: List[List[Tuple[int, int]]] = []

        def rec(lo: int, hi: int, path: List[Tuple[int, int]]) -> None:
            if lo > hi:
                return
            mid = (lo + hi) // 2
            if lo <= mid - 1:
                lmid = (lo + mid - 1) // 2
                e = (mid, lmid)
                out_paths.append(path + [e])
                rec(lo, mid - 1, path + [e])
            if mid + 1 <= hi:
                rmid = (mid + 1 + hi) // 2
                e = (mid, rmid)
                out_paths.append(path + [e])
                rec(mid + 1, hi, path + [e])

        rec(0, self.n - 1, [])
        edge_list: List[Tuple[int, int]] = []
        edge_id: Dict[Tuple[int, int], int] = {}
        for path in out_paths:
            for e in path:
                if e not in edge_id:
                    edge_id[e] = len(edge_list)
                    edge_list.append(e)
        paths_mat = np.zeros((len(out_paths), len(edge_list)), dtype=np.float64)
        for r, path in enumerate(out_paths):
            for e in path:
                paths_mat[r, edge_id[e]] = 1.0
        self._edge_arr = (
            np.asarray(edge_list, dtype=np.int64)
            if edge_list
            else np.zeros((0, 2), dtype=np.int64)
        )
        self._paths_mat = paths_mat
        return []

    def cost_batch(self, perms: np.ndarray) -> np.ndarray:
        if self.mode == "barrier":
            return super().cost_batch(perms)
        perms = _as_batch(perms)
        payload = self.size_bytes / 2.0 if self.size_bytes else 0.0
        total = np.zeros(perms.shape[0])
        if not len(self._edge_arr):
            return total
        for shift in (0, 1):  # tree and its mirrored (rank - 1) twin
            ranks = (self._edge_arr - shift) % self.n
            a = perms[:, ranks[:, 0]]
            b = perms[:, ranks[:, 1]]
            if self.c is not None:
                scale = 0.5 if self.size_bytes else 1.0
                edge = self.c[a, b] * scale                       # [P, E]
            else:
                edge = self.lat[a, b] + payload * self.invbw[a, b]
            path_cost = edge @ self._paths_mat.T                  # [P, R]
            if path_cost.shape[1]:
                total = np.maximum(total, path_cost.max(axis=1))
        return total

    def critical_edges(self, perm: Sequence[int]) -> List[Tuple[int, int, float]]:
        if self.mode == "barrier":
            return super().critical_edges(perm)
        perm = np.asarray(perm)
        payload = self.size_bytes / 2.0 if self.size_bytes else 0.0
        best: Optional[Tuple[float, int, int]] = None
        if not len(self._edge_arr):
            return []
        for shift in (0, 1):
            ranks = (self._edge_arr - shift) % self.n
            a = perm[ranks[:, 0]]
            b = perm[ranks[:, 1]]
            if self.c is not None:
                edge = self.c[a, b] * (0.5 if self.size_bytes else 1.0)
            else:
                edge = self.lat[a, b] + payload * self.invbw[a, b]
            path_cost = edge @ self._paths_mat.T
            if not len(path_cost):
                continue
            r = int(np.argmax(path_cost))
            e_ids = np.nonzero(self._paths_mat[r])[0]
            k = e_ids[int(np.argmax(edge[e_ids]))]
            cand = (float(edge[k]), int(a[k]), int(b[k]))
            if best is None or cand[0] > best[0]:
                best = cand
        return [(best[1], best[2], best[0])] if best else []


class BCubeCost(CostModel):
    """C_b = sum_rounds max over B-peer exchanges of c(S / B^{i+1}).

    Round ``i`` groups ranks by all base-B digits except digit ``i``; each
    rank exchanges with the B-1 peers differing only in digit ``i``
    (paper §IV-A / Gloo's bcube).
    """

    name = "bcube"
    aggregator = "sum_of_max"

    def __init__(self, n, size_bytes, cost_matrix=None, *, base: int = 4, **kw):
        self.base = base
        super().__init__(n, size_bytes, cost_matrix, **kw)

    def _structure_extras(self) -> tuple:
        return (self.base,)

    def _make_rounds(self) -> List[_Round]:
        n, b = self.n, self.base
        n_rounds = _require_power_of_base(n, b, "bcube")
        rounds = []
        for i in range(n_rounds):
            stride = b ** i
            pairs = []
            for j in range(n):
                digit = (j // stride) % b
                for k in range(1, b):
                    p = j + (((digit + k) % b) - digit) * stride
                    if j < p:
                        pairs.append((j, p))
            rounds.append(
                _Round(
                    pairs=np.asarray(pairs, dtype=np.int64),
                    payload=self.size_bytes / (b ** (i + 1)),
                )
            )
        return rounds


class AllToAllCost(CostModel):
    """Beyond-paper: shift-scheduled all-to-all (MoE dispatch/EP traffic).

    N-1 shift rounds; in round k every rank j sends S/N to rank (j+k)%N.
    Reordering changes which shifts cross slow links — the locality
    argument the paper makes for ring applies to EP all-to-alls too.
    """

    name = "all_to_all"
    aggregator = "sum_of_max"

    def _make_rounds(self) -> List[_Round]:
        n = self.n
        j = np.arange(n)
        return [
            _Round(pairs=np.stack([j, (j + k) % n], axis=1), payload=self.size_bytes / n)
            for k in range(1, n)
        ]


COST_MODELS: Dict[str, Callable[..., CostModel]] = {
    "ring": RingCost,
    "halving_doubling": HalvingDoublingCost,
    "double_binary_tree": DoubleBinaryTreeCost,
    "bcube": BCubeCost,
    "all_to_all": AllToAllCost,
}


def make_cost_model(
    algo: str,
    cost_matrix: Optional[np.ndarray] = None,
    size_bytes: float = 0.0,
    *,
    lat: Optional[np.ndarray] = None,
    bw: Optional[np.ndarray] = None,
    **kwargs,
) -> CostModel:
    if algo not in COST_MODELS:
        raise ValueError(
            f"unknown cost model {algo!r}; registered models: "
            f"{', '.join(sorted(COST_MODELS))}")
    if cost_matrix is not None:
        n = cost_matrix.shape[0]
    else:
        n = lat.shape[0]
    return COST_MODELS[algo](n, size_bytes, cost_matrix, lat=lat, bw=bw, **kwargs)
