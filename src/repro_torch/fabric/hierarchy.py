"""Locality-tree inference: recover the hidden datacenter hierarchy.

The paper's setting hides the placement hierarchy from the tenant — all
it can see is the probed pairwise cost matrix (§IV-B).  But the
hierarchy is *in* that matrix: a 3-tier Clos quantizes pairwise costs
into a few well-separated bands (intra-rack ~µs, cross-rack ~tens of
µs, cross-agg ~hundreds), and a TPU fleet separates ICI from DCN by two
orders of magnitude.  This module recovers that structure explicitly:

* :func:`infer_hierarchy` — average-linkage agglomerative clustering
  over the cost matrix with an **automatic tier cut**: merge heights
  inside one physical tier are tightly banded, so tier boundaries show
  up as large gaps (in octaves) between consecutive merge heights.  One
  cut per significant gap yields the recovered tiers, finest first.
* :class:`HierarchyModel` — the recovered locality tree: nested
  partitions per tier, the cut heights, ultrametric
  :meth:`~HierarchyModel.distance_ranks`, and a JSON round-trip so plan
  caches can persist the tree.

Downstream consumers: hierarchy-decomposed solving
(:func:`repro_torch.core.reorder.optimize_rank_order_hierarchical`), sparse
probe completion (:mod:`repro_torch.fabric.sparse`), and tree-sketch plan
fingerprints (:func:`repro_torch.plan.cache.fabric_fingerprint`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["HierarchyModel", "infer_hierarchy"]


Blocks = Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class HierarchyModel:
    """A recovered locality tree over ``n`` endpoints.

    ``tiers[t]`` is the node partition at tier ``t`` — finest first
    (racks before aggregation domains before the fabric root).  The
    partitions are nested: every block of tier ``t`` is contained in
    exactly one block of tier ``t+1``.  ``heights[t]`` is the cost
    threshold (seconds) the tier was cut at.  An empty ``tiers`` means
    the matrix showed no separable structure (a flat/uniform fabric).
    """

    n: int
    tiers: Tuple[Blocks, ...]
    heights: Tuple[float, ...]

    def __post_init__(self) -> None:
        assert len(self.tiers) == len(self.heights)

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def flat(self) -> bool:
        """True when no hierarchy was recovered (no exploitable tiers)."""
        return not self.tiers

    def blocks(self, tier: int = 0) -> List[List[int]]:
        """The node blocks at ``tier`` (0 = finest).  Flat model: one
        block per node at any tier."""
        if self.flat:
            return [[i] for i in range(self.n)]
        return [list(b) for b in self.tiers[tier]]

    def labels(self, tier: int = 0) -> np.ndarray:
        """[n] block id per node at ``tier`` (0 = finest)."""
        out = np.zeros(self.n, dtype=np.int64)
        if self.flat:
            return np.arange(self.n, dtype=np.int64)
        for b_id, block in enumerate(self.tiers[tier]):
            out[list(block)] = b_id
        return out

    def distance_ranks(self) -> np.ndarray:
        """Ultrametric tier distance: ``rank[i, j]`` = number of tiers
        whose partition separates i from j (0 = same finest block).

        This is the tree's own cost matrix — integer, noise-free, and
        exactly what rank-distance-structured schedules care about.
        """
        r = np.zeros((self.n, self.n), dtype=np.int64)
        for t in range(self.n_tiers):
            lab = self.labels(t)
            r += (lab[:, None] != lab[None, :]).astype(np.int64)
        return r

    def restrict(self, nodes: Sequence[int]) -> "HierarchyModel":
        """The tree over a node subset, re-indexed to local ids.

        ``nodes[k]`` becomes local id ``k`` (the plan compiler's group →
        local-rank convention).  Blocks that lose all members vanish;
        tiers whose partition collapses to a single block (or to all
        singletons) are dropped — they carry no structure over the
        subset.
        """
        nodes = [int(x) for x in nodes]
        local = {node: k for k, node in enumerate(nodes)}
        if len(local) != len(nodes):
            raise ValueError("HierarchyModel.restrict needs unique node ids")
        tiers: List[Blocks] = []
        heights: List[float] = []
        for tier, h in zip(self.tiers, self.heights):
            part = tuple(
                tuple(sorted(local[x] for x in block if x in local))
                for block in tier)
            part = tuple(b for b in part if b)
            if len(part) <= 1 or all(len(b) == 1 for b in part):
                continue
            if tiers and part == tiers[-1]:
                continue
            tiers.append(part)
            heights.append(h)
        return HierarchyModel(n=len(nodes), tiers=tuple(tiers),
                              heights=tuple(heights))

    # -- presentation ------------------------------------------------------
    def describe(self) -> str:
        """One line per tier, finest first — for CLI probe/plan dumps."""
        if self.flat:
            return f"hierarchy: flat ({self.n} nodes, no separable tiers)"
        lines = [f"hierarchy: {self.n} nodes, {self.n_tiers} tiers"]
        for t in range(self.n_tiers):
            sizes = [len(b) for b in self.tiers[t]]
            lines.append(
                f"  tier {t}: {len(sizes)} blocks "
                f"(size {min(sizes)}..{max(sizes)}, "
                f"mean {sum(sizes) / len(sizes):.1f}) "
                f"cut @ {self.heights[t] * 1e6:.1f}us")
        return "\n".join(lines)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "tiers": [[list(b) for b in tier] for tier in self.tiers],
            "heights": list(self.heights),
        }

    @staticmethod
    def from_dict(d: dict) -> "HierarchyModel":
        return HierarchyModel(
            n=int(d["n"]),
            tiers=tuple(
                tuple(tuple(int(x) for x in b) for b in tier)
                for tier in d["tiers"]),
            heights=tuple(float(h) for h in d["heights"]),
        )


# ---------------------------------------------------------------------------
# agglomerative inference
# ---------------------------------------------------------------------------

def _average_linkage(c: np.ndarray) -> List[Tuple[int, int, float]]:
    """UPGMA merges over the full matrix: [(rep_i, rep_j, height), ...].

    Lance–Williams update in place — each of the n-1 merges is one O(n)
    row recombination plus an O(n^2) argmin, so the whole dendrogram is
    a few numpy passes even at n=1024.  Average linkage is reducible,
    so merge heights are non-decreasing (no inversions) — the property
    the gap-based tier cut below relies on.
    """
    n = c.shape[0]
    D = np.asarray(c, dtype=np.float64).copy()
    np.fill_diagonal(D, np.inf)
    size = np.ones(n)
    merges: List[Tuple[int, int, float]] = []
    for _ in range(n - 1):
        k = int(np.argmin(D))
        i, j = divmod(k, n)
        if i > j:
            i, j = j, i
        h = float(D[i, j])
        merges.append((i, j, h))
        si, sj = size[i], size[j]
        row = (si * D[i] + sj * D[j]) / (si + sj)
        D[i, :] = row
        D[:, i] = row
        D[i, i] = np.inf
        D[j, :] = np.inf
        D[:, j] = np.inf
        size[i] = si + sj
    return merges


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _partition_at(n: int, merges: Sequence[Tuple[int, int, float]],
                  threshold: float) -> Blocks:
    """Dendrogram cut: connected components of merges below threshold."""
    uf = _UnionFind(n)
    for i, j, h in merges:
        if h <= threshold:
            uf.union(i, j)
    groups: dict = {}
    for x in range(n):
        groups.setdefault(uf.find(x), []).append(x)
    return tuple(tuple(sorted(g)) for g in
                 sorted(groups.values(), key=lambda g: g[0]))


def infer_hierarchy(cost_matrix: np.ndarray,
                    max_tiers: int = 3,
                    gap_octaves: float = 0.75,
                    min_merges_below: int = 1) -> HierarchyModel:
    """Recover the locality tree from a probed pairwise cost matrix.

    Agglomerate with average linkage, then cut the dendrogram wherever
    consecutive sorted merge heights jump by more than ``gap_octaves``
    (log2): probe noise moves same-tier heights by fractions of an
    octave, while Clos/DCN tier boundaries are 1–7 octaves wide.  At
    most ``max_tiers`` cuts are kept (the largest gaps win), finest
    first.  A matrix with no significant gap yields a *flat* model
    (``HierarchyModel.flat``) — consumers then fall back to the dense
    paths.
    """
    c = np.asarray(cost_matrix, dtype=np.float64)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(
            f"infer_hierarchy needs a square [n, n] cost matrix; got "
            f"shape {c.shape}")
    n = c.shape[0]
    if n < 4:
        return HierarchyModel(n=n, tiers=(), heights=())
    c = np.maximum(c, c.T)
    merges = _average_linkage(c)
    hs = np.asarray([h for (_, _, h) in merges], dtype=np.float64)
    # Guard degenerate zero heights (identical rows) before the log.
    floor = max(float(hs.max()), 1e-30) * 1e-12
    log_h = np.log2(np.maximum(np.sort(hs), floor))
    gaps = np.diff(log_h)
    cut_idx = [int(k) for k in np.argsort(gaps)[::-1]
               if gaps[k] > gap_octaves][:max_tiers]
    cut_idx = sorted(cut_idx)
    tiers: List[Blocks] = []
    heights: List[float] = []
    sorted_h = np.sort(hs)
    seen: set = set()
    for k in cut_idx:
        if k + 1 < min_merges_below:
            continue
        # geometric midpoint of the straddling heights: maximally far
        # (in octaves) from both tiers' merge bands
        theta = float(np.sqrt(max(sorted_h[k], floor) * sorted_h[k + 1]))
        part = _partition_at(n, merges, theta)
        key = tuple(part)
        if len(part) <= 1 or key in seen:
            continue
        seen.add(key)
        tiers.append(part)
        heights.append(theta)
    return HierarchyModel(n=n, tiers=tuple(tiers), heights=tuple(heights))
