"""Rank reordering — the paper's technique, N-D generalized.

A copy of ``repro.core.reorder``.  The paper reorders a flat rank list and
feeds it to an unmodified backend.  In the reference the "rank list" is
the device array inside a JAX mesh; in the port it is the rank order of
a process group, or, on the single-card virtual mesh, the ring order of
the certified schedule the reducer runs.  Permuting it changes which
physical links every ring / all-gather hop crosses, with no change to
the model or the step.  (See DESIGN.md §2.)

1-D (paper-faithful): :func:`optimize_rank_order`.

N-D (beyond paper): a production mesh ``(pod, data, model)`` runs
collectives on *every* axis, with very different traffic:

* ``model`` (TP): all-gather/reduce-scatter per layer, every microbatch —
  the hot axis;
* ``data``/``pod`` (DP): one gradient reduce-scatter+all-gather per step.

:func:`optimize_mesh_assignment` therefore solves hierarchically, hottest
axis first: partition devices into same-group sets with minimal intra-
group cost (greedy agglomeration), order each group with the ring TSP
solver, then collapse groups to supernodes (mean inter-group cost) and
recurse on the next axis.  The result is an integer array of shape
``mesh_shape`` assigning a device id to every mesh coordinate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fabric.hierarchy import HierarchyModel

from .cost_models import make_cost_model
from .solver import SolveResult, or_opt, solve, two_opt

__all__ = [
    "optimize_rank_order",
    "optimize_rank_order_hierarchical",
    "hierarchical_perm",
    "optimize_mesh_assignment",
    "mesh_axis_cost",
    "mesh_total_cost",
    "MeshPlan",
    "random_assignment",
]


def optimize_rank_order(
    cost_matrix: np.ndarray,
    algo: str = "ring",
    size_bytes: float = 0.0,
    method: str = "auto",
    seed: int = 0,
    iters: int = 3000,
    **kwargs,
) -> SolveResult:
    """Paper-faithful flat reordering: minimize C_algo over permutations."""
    model = make_cost_model(algo, cost_matrix, size_bytes, **kwargs)
    return solve(model, method=method, seed=seed, iters=iters)


# ---------------------------------------------------------------------------
# hierarchy-decomposed solving
# ---------------------------------------------------------------------------

def _unit_mean_cost(c: np.ndarray, units: Sequence[Sequence[int]]) -> np.ndarray:
    """Mean inter-unit cost via one indicator matmul (no python loops)."""
    m = len(units)
    a = np.zeros((m, c.shape[0]))
    for u, members in enumerate(units):
        a[u, list(members)] = 1.0 / len(members)
    nc = a @ c @ a.T
    np.fill_diagonal(nc, 0.0)
    return nc


def _splice(c: np.ndarray, ordered_units: Sequence[Sequence[int]]) -> List[int]:
    """Concatenate pre-ordered units, flipping each to cheapen the junction."""
    out = list(ordered_units[0])
    for u in ordered_units[1:]:
        u = list(u)
        if c[out[-1], u[-1]] < c[out[-1], u[0]]:
            u.reverse()
        out.extend(u)
    return out


def hierarchical_perm(cost_matrix: np.ndarray,
                      hierarchy: Optional[HierarchyModel],
                      seed: int = 0) -> np.ndarray:
    """A locality-nested ring permutation from the recovered tree.

    Bottom-up over the tiers: order the nodes inside every finest block
    (2-opt + Or-opt on the tiny submatrix), collapse each ordered block
    to a supernode (mean inter-block cost), order the supernodes within
    their parent block, splice, recurse.  Total work is a stack of
    small solves — O(n · b) for blocks of size b — instead of one flat
    n-sized search, which is where the ≥3x solve speedup at N=1024
    comes from (see benchmarks/fabric_probe.py).

    The permutation is algorithm-agnostic (pure locality nesting), so
    the plan compiler computes it once per entry and scores it under
    every candidate algorithm's cost model.
    """
    c = np.asarray(cost_matrix, dtype=np.float64)
    n = c.shape[0]
    if hierarchy is None or hierarchy.flat:
        return np.asarray(_order_ring(c, list(range(n))), dtype=np.int64)
    if hierarchy.n != n:
        raise ValueError(
            f"hierarchy covers {hierarchy.n} nodes but the cost matrix has "
            f"{n}; restrict() the hierarchy to the group first")
    units: List[List[int]] = [
        _order_ring(c, list(b)) for b in hierarchy.blocks(0)]
    for t in range(1, hierarchy.n_tiers + 1):
        if len(units) == 1:
            break
        if t < hierarchy.n_tiers:
            lab = hierarchy.labels(t)
            parents = [int(lab[u[0]]) for u in units]
        else:
            parents = [0] * len(units)
        nc = _unit_mean_cost(c, units)
        groups: Dict[int, List[int]] = {}
        for idx, p in enumerate(parents):
            groups.setdefault(p, []).append(idx)
        new_units: List[List[int]] = []
        for p in sorted(groups):
            order = _order_ring(nc, groups[p])
            new_units.append(_splice(c, [units[i] for i in order]))
        units = new_units
    if len(units) > 1:                     # top tier did not reach the root
        nc = _unit_mean_cost(c, units)
        order = _order_ring(nc, list(range(len(units))))
        units = [_splice(c, [units[i] for i in order])]
    return np.asarray(units[0], dtype=np.int64)


def optimize_rank_order_hierarchical(
    cost_matrix: np.ndarray,
    hierarchy: Optional[HierarchyModel],
    algo: str = "ring",
    size_bytes: float = 0.0,
    seed: int = 0,
    **kwargs,
) -> SolveResult:
    """Rank reordering by hierarchy decomposition (solve per cluster,
    then inter-cluster over supernodes) instead of a flat n-sized
    stochastic search.  Falls back to the flat construction heuristic
    on a flat (structureless) hierarchy."""
    timer = obs.tracer().timer("reorder.hierarchical", algo=algo)
    with timer:
        model = make_cost_model(algo, cost_matrix, size_bytes, **kwargs)
        perm = hierarchical_perm(cost_matrix, hierarchy, seed=seed)
        cost = float(model.cost(perm))
    return SolveResult(perm=perm, cost=cost,
                       trace=[("hierarchical", 0, cost)],
                       wall_s=timer.elapsed)


# ---------------------------------------------------------------------------
# N-D mesh assignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshPlan:
    """Result of an N-D mesh reordering."""

    assignment: np.ndarray          # int array, shape mesh_shape -> device id
    axis_names: Tuple[str, ...]
    cost: float                     # weighted objective after optimization
    baseline_cost: float            # same objective for the identity order
    per_axis: Dict[str, float]      # optimized per-axis cost

    @property
    def flat(self) -> np.ndarray:
        return self.assignment.reshape(-1)


def _group_greedy(c: np.ndarray, units: List[int], k: int) -> List[List[int]]:
    """Partition ``units`` into groups of size k with low intra-group cost.

    Greedy agglomeration: seed each group with the unassigned unit that is
    farthest from all others (hardest to place), then grow by repeatedly
    adding the unit with the smallest mean cost to the current group.

    Vectorized: instead of re-slicing submatrices per pick (the seed's
    O(m^2 k) inner loops), two running sum vectors — cost-to-remaining
    and cost-to-current-group — are updated with one O(m) axpy per pick,
    so the whole partition is O(m^2) with m numpy ops total.
    """
    units = list(units)
    m = len(units)
    active = np.ones(m, dtype=bool)
    cu = c if units == list(range(c.shape[0])) else c[np.ix_(units, units)]
    sum_rem = cu.sum(axis=1)                       # cost to remaining units
    groups: List[List[int]] = []
    n_active = m
    while n_active > k:
        seed_i = int(np.argmax(np.where(active, sum_rem, -np.inf)))
        group = [seed_i]
        active[seed_i] = False
        sum_rem -= cu[:, seed_i]
        sum_grp = cu[:, seed_i].copy()             # cost to current group
        while len(group) < k:
            pick = int(np.argmin(np.where(active, sum_grp, np.inf)))
            group.append(pick)
            active[pick] = False
            sum_rem -= cu[:, pick]
            sum_grp += cu[:, pick]
        groups.append(group)
        n_active -= k
    rest = np.nonzero(active)[0]
    if rest.size:
        groups.append([int(i) for i in rest])
    return [[units[i] for i in g] for g in groups]


def _group_greedy_reference(c: np.ndarray, units: List[int], k: int) -> List[List[int]]:
    """Seed greedy agglomeration (per-pick submatrix slicing), kept
    verbatim for the equivalence property tests and benchmarks."""
    remaining = set(units)
    groups: List[List[int]] = []
    while remaining:
        rem = list(remaining)
        if len(rem) <= k:
            groups.append(rem)
            break
        sub = c[np.ix_(rem, rem)]
        seed_i = rem[int(np.argmax(sub.sum(axis=1)))]
        group = [seed_i]
        remaining.remove(seed_i)
        while len(group) < k:
            rem = list(remaining)
            costs = c[np.ix_(rem, group)].mean(axis=1)
            pick = rem[int(np.argmin(costs))]
            group.append(pick)
            remaining.remove(pick)
        groups.append(group)
    return groups


def _order_ring(c: np.ndarray, members: List[int]) -> List[int]:
    """Order ``members`` along a ring with 2-opt + Or-opt on the submatrix."""
    if len(members) <= 3:
        return list(members)
    sub = c[np.ix_(members, members)]
    perm = two_opt(sub, np.arange(len(members)))
    perm = or_opt(sub, perm)
    return [members[i] for i in perm]


def default_axis_weights(axis_names: Sequence[str]) -> Dict[str, float]:
    """Relative traffic weights per axis role (TP >> DP > pod-DP)."""
    w = {}
    for name in axis_names:
        if name in ("model", "tensor", "tp"):
            w[name] = 100.0     # per-layer activation collectives
        elif name in ("expert", "ep"):
            w[name] = 30.0      # per-layer all-to-alls
        elif name in ("data", "fsdp", "dp"):
            w[name] = 10.0      # per-step gradient reduction
        elif name in ("pod", "dcn"):
            w[name] = 1.0       # per-step, but DCN bytes are precious
        else:
            w[name] = 1.0
    return w


def _collapse_cost(cost_matrix: np.ndarray, new_units: List[List[int]]) -> np.ndarray:
    """Inter-group mean cost matrix after collapsing groups to supernodes.

    All units have equal size on the mesh path, so the seed's O(m^2)
    Python loop of submatrix ``.mean()`` calls becomes one blocked
    reduction: gather the permuted matrix, reshape to [m, b, m, b], mean
    over the block axes.
    """
    m = len(new_units)
    sizes = {len(u) for u in new_units}
    if len(sizes) == 1:
        ids = np.asarray(new_units, dtype=np.int64).reshape(-1)
        b = len(new_units[0])
        blk = cost_matrix[np.ix_(ids, ids)].reshape(m, b, m, b)
        nc = blk.mean(axis=(1, 3))
        np.fill_diagonal(nc, 0.0)
        return nc
    return _collapse_cost_reference(cost_matrix, new_units)


def _collapse_cost_reference(cost_matrix: np.ndarray,
                             new_units: List[List[int]]) -> np.ndarray:
    """Seed supernode collapse: O(m^2) Python loop of submatrix means.

    Kept as the ``engine="reference"`` implementation and as
    :func:`_collapse_cost`'s unequal-size fallback.
    """
    m = len(new_units)
    nc = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i == j:
                continue
            nc[i, j] = cost_matrix[np.ix_(new_units[i], new_units[j])].mean()
    return nc


def optimize_mesh_assignment(
    cost_matrix: np.ndarray,
    mesh_shape: Sequence[int],
    axis_names: Sequence[str],
    axis_weights: Optional[Dict[str, float]] = None,
    seed: int = 0,
    engine: str = "vectorized",
    hierarchy: Optional[HierarchyModel] = None,
) -> MeshPlan:
    """Hierarchical N-D rank reordering (see module docstring).

    ``engine="reference"`` runs the seed implementation (per-pick
    submatrix means in the grouping loop, O(m^2) Python supernode
    collapse) — kept for equivalence tests and benchmarks.

    ``hierarchy``, when given (a recovered
    :class:`repro_torch.fabric.HierarchyModel`), replaces the greedy
    agglomeration on the hottest axis with supernode collapse over the
    inferred blocks: devices are laid out along a locality-nested ring
    (:func:`hierarchical_perm`) and the axis groups are consecutive
    slices of it — already local, already ordered.
    """
    mesh_shape = tuple(mesh_shape)
    axis_names = tuple(axis_names)
    n = int(np.prod(mesh_shape))
    assert cost_matrix.shape == (n, n)
    weights = axis_weights or default_axis_weights(axis_names)
    group_greedy = (_group_greedy_reference if engine == "reference"
                    else _group_greedy)

    # Process axes hottest-first; by convention that is innermost-first
    # (model), which also matches how group nesting composes.
    order = sorted(range(len(mesh_shape)), key=lambda a: -weights[axis_names[a]])

    # units: currently-assembled blocks of device ids, in axis-nesting order.
    units: List[List[int]] = [[i] for i in range(n)]
    unit_cost = cost_matrix.copy()

    axis_members: Dict[int, List[List[int]]] = {}
    for a in order:
        k = mesh_shape[a]
        ids = list(range(len(units)))
        if hierarchy is not None and not hierarchy.flat \
                and engine != "reference" and len(units) == n:
            # hottest axis over the raw devices: slice the locality-
            # nested ring instead of greedy agglomeration from scratch
            ring = hierarchical_perm(unit_cost, hierarchy, seed=seed)
            groups = [list(ring[i:i + k]) for i in range(0, n, k)]
            groups = [_order_ring(unit_cost, g) for g in groups]
        else:
            groups = group_greedy(unit_cost, ids, k)
            groups = [_order_ring(unit_cost, g) for g in groups]
        axis_members[a] = groups
        # Collapse: each ordered group becomes one unit.
        new_units: List[List[int]] = []
        for g in groups:
            merged: List[int] = []
            for u in g:
                merged.extend(units[u])
            new_units.append(merged)
        if engine == "reference":
            nc = _collapse_cost_reference(cost_matrix, new_units)
        else:
            nc = _collapse_cost(cost_matrix, new_units)
        units, unit_cost = new_units, nc

    # Reassemble the assignment: the nesting order of merges is `order`
    # reversed; reconstruct coordinates by unrolling group structure.
    # After the loop, len(units) == 1 and units[0] lists device ids in
    # nesting order: outermost processed axis slowest.
    flat = np.asarray(units[0], dtype=np.int64)
    # The merge loop nested blocks as [last-processed axis outermost ...
    # first-processed innermost]; reshape accordingly, then permute the
    # dims back to canonical mesh-axis order.
    rev = list(reversed(order))
    arr = flat.reshape([mesh_shape[a] for a in rev])
    assignment = np.transpose(arr, axes=[rev.index(a) for a in range(len(order))])

    base = np.arange(n, dtype=np.int64).reshape(mesh_shape)
    per_axis = {
        axis_names[a]: mesh_axis_cost(assignment, cost_matrix, a)
        for a in range(len(mesh_shape))
    }
    cost = mesh_total_cost(assignment, cost_matrix, axis_names, weights)
    baseline = mesh_total_cost(base, cost_matrix, axis_names, weights)
    return MeshPlan(
        assignment=assignment,
        axis_names=axis_names,
        cost=cost,
        baseline_cost=baseline,
        per_axis=per_axis,
    )


def mesh_axis_cost(
    assignment: np.ndarray, cost_matrix: np.ndarray, axis: int, algo: str = "ring"
) -> float:
    """Mean collective cost over all groups along ``axis`` of the assignment.

    All groups share one schedule structure (they have the same size), so
    every group is evaluated in a single batched gather over the full
    cost matrix — the structure comes from one template model, the node
    ids from the assignment rows.  Models without a flat round structure
    (the path-mode tree) fall back to the per-group loop.

    ``cost_matrix`` may be a :class:`repro_torch.fabric.HierarchyModel`: the
    assignment is then priced on the tree's ultrametric
    :meth:`~repro_torch.fabric.HierarchyModel.distance_ranks` — how many tier
    boundaries each hop crosses — which is noise-free and needs no
    probed matrix at all (drift-robust plan comparisons).
    """
    if isinstance(cost_matrix, HierarchyModel):
        cost_matrix = cost_matrix.distance_ranks().astype(np.float64)
    arr = np.moveaxis(assignment, axis, -1)
    groups = arr.reshape(-1, arr.shape[-1])
    g = groups.shape[1]
    if g < 2:
        return 0.0
    if algo == "ring":
        total = cost_matrix[groups, np.roll(groups, 1, axis=1)].sum()
        return float(total / len(groups))
    template = make_cost_model(algo, np.zeros((g, g)), 0.0)
    if template.rounds:
        total = np.zeros(len(groups))
        for rnd in template.rounds:
            a = groups[:, rnd.pairs[:, 0]]
            b = groups[:, rnd.pairs[:, 1]]
            edge = cost_matrix[a, b]
            if template.aggregator == "sum_of_max":
                total += edge.max(axis=1)
            else:
                total += edge.sum(axis=1)
        return float(total.sum() / len(groups))
    total = 0.0
    for grp in groups:
        sub = cost_matrix[np.ix_(grp, grp)]
        sub_model = make_cost_model(algo, sub, 0.0)
        total += sub_model.cost(np.arange(len(grp)))
    return total / max(len(groups), 1)


def mesh_total_cost(
    assignment: np.ndarray,
    cost_matrix: np.ndarray,
    axis_names: Sequence[str],
    axis_weights: Optional[Dict[str, float]] = None,
) -> float:
    weights = axis_weights or default_axis_weights(axis_names)
    if isinstance(cost_matrix, HierarchyModel):
        cost_matrix = cost_matrix.distance_ranks().astype(np.float64)
    return float(
        sum(
            weights[axis_names[a]] * mesh_axis_cost(assignment, cost_matrix, a)
            for a in range(assignment.ndim)
        )
    )


def random_assignment(mesh_shape: Sequence[int], seed: int = 0) -> np.ndarray:
    n = int(np.prod(tuple(mesh_shape)))
    return np.random.default_rng(seed).permutation(n).reshape(tuple(mesh_shape))
