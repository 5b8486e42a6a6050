"""The graceful-degradation ladder (a copy of ``repro.faults.ladder``).

When the fabric changes under a session — a preemption takes 25% of the
nodes, a congestion episode invalidates the plan, a re-plan compile
itself fails — the session must keep serving *some* valid order.  The
ladder tries progressively cheaper (and progressively less optimal)
recoveries, and its bottom rung can never fail:

1. **warm-start re-solve** (:func:`recover_entry`) — restrict the
   previous permutation to the surviving ranks (``Fabric.subset`` /
   ``HierarchyModel.restrict`` semantics: drop the dead, keep the
   order) and refine it with the budgeted local search (2-opt +
   Or-opt for ring objectives, batched swap hill-climb otherwise).  No
   simulated annealing, no candidate sweep — milliseconds, not seconds.
2. **bottleneck-swap hot-patch** — the paper §VI repair: fix only the
   critical edge (:func:`repro_torch.core.dynamic.bottleneck_swap`).
3. **stale** — serve the restricted previous order unrefined.
4. **identity** — fall back to identity order, which by construction
   cannot be worse than identity.

Every rung is guarded by the entry's own cost model: a recovered order
that prices worse than identity is replaced by identity, so the ladder
invariant — *the served order is never worse than identity order* —
holds at every rung (the chaos suite referees this on the simulator).

:func:`recover_plan` applies the ladder to a whole plan after an
elastic membership change, remapping every cached
:class:`~repro_torch.plan.compiler.PlanEntry` to the new numbering; entries
whose algorithm is infeasible at the new group size (a power-of-two
builder after losing a node) are re-selected among the feasible
candidates, scored at the warm-started order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.collective import candidates as builder_candidates
from repro_torch.collective import get_builder
from repro_torch.core.cost_models import RingCost, make_cost_model
from repro_torch.core.dynamic import bottleneck_swap
from repro_torch.core.solver import or_opt, swap_hill_climb, two_opt

__all__ = [
    "LADDER_RUNGS",
    "restrict_perm",
    "warm_refine",
    "recover_entry",
    "recover_plan",
    "identity_fallback",
]

#: rung names, best first (see module doc)
LADDER_RUNGS = ("warm_resolve", "hot_patch", "stale", "identity")


def restrict_perm(perm: Sequence[int], keep: Sequence[int]) -> List[int]:
    """Drop the dead from a permutation, preserving the survivors' order.

    ``perm`` lists node ids in rank order; ``keep`` is the surviving id
    set.  This is the warm-start seed: locality the solver already paid
    for survives the membership change.
    """
    keep_set = set(int(x) for x in keep)
    return [int(x) for x in perm if int(x) in keep_set]


def _ring_edge_matrix(model) -> np.ndarray:
    """Symmetric edge-cost matrix of a ring objective (for 2-opt/Or-opt)."""
    if model.c is not None:
        return model.c
    return model.lat + model.size_bytes * model.invbw


def warm_refine(model, start_local: np.ndarray,
                sweeps: int = 4) -> np.ndarray:
    """Budgeted local refinement from a warm start (no SA).

    Ring objectives get alternating 2-opt / Or-opt sweeps on the edge
    matrix; everything else gets the batched swap hill-climb.  The
    budget (``sweeps``) keeps recovery at milliseconds — the whole
    point of warm-starting is skipping the cold SA search.
    """
    start_local = np.asarray(start_local, dtype=np.int64)
    if isinstance(model, RingCost):
        c = _ring_edge_matrix(model)
        refined = or_opt(c, two_opt(c, start_local, max_sweeps=sweeps),
                         max_sweeps=sweeps)
        # the tour refiners optimize the symmetric edge matrix; keep the
        # warm start if the model objective says they regressed
        if model.cost(refined) <= model.cost(start_local):
            return np.asarray(refined, dtype=np.int64)
        return start_local
    return np.asarray(swap_hill_climb(model, start_local,
                                      max_sweeps=sweeps), dtype=np.int64)


def _choose_algorithm(entry, n_new: int, model_for, start_local: np.ndarray,
                      ) -> Tuple[str, Dict[str, int], object]:
    """Keep the entry's algorithm when feasible at ``n_new``; otherwise
    re-select among feasible candidates, scored at the warm order."""
    cands = builder_candidates(entry.op, n_new)
    if not cands:
        raise ValueError(
            f"no feasible algorithm for {entry.op!r} over {n_new} nodes")
    if get_builder(entry.algo).feasible(n_new):
        for name, akw in cands:
            if name == entry.algo:
                # candidate kwargs win over the stored ones: bcube's
                # base-4 variant may be infeasible at the new size
                return name, akw, model_for(name, akw)
    best = None
    for name, akw in cands:
        m = model_for(name, akw)
        t = float(m.cost(start_local))
        if best is None or t < best[0]:
            best = (t, name, akw, m)
    return best[1], best[2], best[3]


def recover_entry(entry, old_to_new: Dict[int, int],
                  lat: np.ndarray, bw: Optional[np.ndarray],
                  append_new: Sequence[int] = (),
                  hierarchy=None, sweeps: int = 4, seed: int = 0,
                  ):
    """Remap one plan entry onto the new membership; returns
    ``(new_entry, rung)`` or ``(None, "dropped")`` when fewer than two
    of the entry's nodes survive.

    ``old_to_new`` maps surviving old node ids to their ids in the new
    numbering; ``lat``/``bw`` are matrices over the new numbering.
    ``append_new`` lists new-numbering ids to add to the group (nodes
    that joined); they are appended to the warm-start order and placed
    by the refinement sweeps.  ``hierarchy`` — a
    :class:`~repro_torch.fabric.HierarchyModel` over the new numbering (e.g.
    the previous tree put through ``restrict``) — contributes a
    locality-nested candidate order that competes with the refined
    warm start.
    """
    from repro_torch.plan.compiler import PlanEntry  # local: faults <-> plan cycle

    members = [old_to_new[x] for x in entry.group if x in old_to_new]
    members = sorted(set(members) | set(int(x) for x in append_new))
    n_g = len(members)
    if n_g < 2:
        return None, "dropped"
    g = np.asarray(members, dtype=np.int64)
    sub_lat = lat[np.ix_(g, g)]
    sub_bw = bw[np.ix_(g, g)] if bw is not None else None
    pos = {node: i for i, node in enumerate(members)}

    # warm start: previous rank order restricted to survivors (+ joiners
    # appended; refinement finds their slots)
    warm_nodes = [old_to_new[x] for x in entry.perm if x in old_to_new]
    warm_local = [pos[x] for x in warm_nodes if x in pos]
    warm_local += [pos[int(x)] for x in append_new if int(x) in pos
                   and pos[int(x)] not in set(warm_local)]
    if len(warm_local) != n_g:   # stale perm missing members: fall back
        warm_local = list(range(n_g))
    warm_local = np.asarray(warm_local, dtype=np.int64)
    identity_local = np.arange(n_g)

    def model_for(name: str, akw: Dict[str, int]):
        m_algo = get_builder(name).cost_model
        kwargs = {"base": akw["base"]} if "base" in akw else {}
        if sub_bw is not None:
            return make_cost_model(m_algo, size_bytes=entry.size_bytes,
                                   lat=sub_lat, bw=sub_bw, **kwargs)
        return make_cost_model(m_algo, cost_matrix=sub_lat,
                               size_bytes=entry.size_bytes, **kwargs)

    algo, akw, model = _choose_algorithm(entry, n_g, model_for, warm_local)

    rung = None
    chosen = None
    try:                                           # rung 1: warm re-solve
        chosen = warm_refine(model, warm_local, sweeps=sweeps)
        rung = "warm_resolve"
    except Exception:
        try:                                       # rung 2: hot-patch
            chosen, _, _ = bottleneck_swap(model, warm_local, max_rounds=4)
            chosen = np.asarray(chosen, dtype=np.int64)
            rung = "hot_patch"
        except Exception:                          # rung 3: stale
            chosen = warm_local
            rung = "stale"

    if hierarchy is not None and not getattr(hierarchy, "flat", True):
        # locality-nested candidate from the restricted tree; it wins
        # only when it prices better than the refined warm start
        try:
            from repro_torch.core.reorder import hierarchical_perm
            from repro_torch.fabric import combine_cost

            sub_h = hierarchy.restrict(members)
            if not sub_h.flat:
                hl = hierarchical_perm(
                    combine_cost(sub_lat, sub_bw, entry.size_bytes),
                    sub_h, seed=seed)
                if model.cost(hl) < model.cost(chosen):
                    chosen = np.asarray(hl, dtype=np.int64)
        except Exception:
            pass                                   # candidate only; optional

    # rung 4 guard (always on): never worse than identity
    ident_t = float(model.cost(identity_local))
    chosen_t = float(model.cost(chosen))
    if not np.isfinite(chosen_t) or chosen_t > ident_t:
        chosen, chosen_t, rung = identity_local, ident_t, "identity"

    obs.metrics().counter(f"faults.ladder.{rung}").inc()
    new = PlanEntry(
        op=entry.op, bucket=entry.bucket, size_bytes=entry.size_bytes,
        group=tuple(members), algo=algo, algo_kwargs=dict(akw),
        chunks=entry.chunks if algo == entry.algo else 1,
        perm=tuple(int(x) for x in g[chosen]),
        expected_time=chosen_t,
        identity_times={algo: ident_t},
        solver_cost=chosen_t, oracle="cost_model",
        program_fingerprint="",
    )
    return new, rung


def recover_plan(plan, old_to_new: Dict[int, int],
                 lat: np.ndarray, bw: Optional[np.ndarray],
                 hierarchy=None, joiners: Sequence[int] = (),
                 sweeps: int = 4, seed: int = 0):
    """Warm-recover a whole plan onto the new membership.

    Returns ``(new_plan, rungs)`` where ``rungs`` maps each old entry
    key to the ladder rung its recovery used.  Entries that spanned the
    whole old fabric absorb ``joiners`` (new-numbering ids); sub-group
    entries only shrink.  The mesh plan is dropped — an N-D assignment
    cannot survive a node-count change; re-plan for a new mesh shape.
    """
    from repro_torch.plan.cache import fabric_fingerprint
    from repro_torch.plan.compiler import Plan

    # the obs timer replaces the ad-hoc perf_counter pair: recovery
    # latency is a product number (compile_seconds of the recovered
    # plan) and a trace span whenever tracing is on
    timer = obs.tracer().timer("faults.recover_plan",
                               entries=len(plan.entries))
    with timer:
        n_new = lat.shape[0]
        entries = {}
        rungs: Dict[Tuple, str] = {}
        for key, entry in plan.entries.items():
            was_full = len(entry.group) == plan.n
            new_entry, rung = recover_entry(
                entry, old_to_new, lat, bw,
                append_new=tuple(joiners) if was_full else (),
                hierarchy=hierarchy, sweeps=sweeps, seed=seed)
            rungs[key] = rung
            if new_entry is not None:
                entries[(new_entry.op, new_entry.bucket, new_entry.group)] = \
                    new_entry
        fp = fabric_fingerprint(lat, bw, hierarchy=hierarchy)
    obs.metrics().histogram("faults.recover.seconds", scale=1e-3).observe(
        timer.elapsed)
    new_plan = Plan(
        fingerprint=fp, n=n_new, entries=entries, mesh_plan=None,
        compile_seconds=timer.elapsed, mix_key=plan.mix_key,
        meta=dict(plan.meta,
                  recovered_from=plan.fingerprint.digest,
                  rungs={str(k): v for k, v in rungs.items()},
                  hierarchy=hierarchy.to_dict() if hierarchy is not None
                  and not getattr(hierarchy, "flat", True) else None),
    )
    return new_plan, rungs


def identity_fallback(plan) -> int:
    """Bottom of the ladder: pin every entry to identity order in place.

    Returns the number of entries changed.  Identity order is the
    no-reordering baseline — by definition it cannot be worse than
    itself, so a halted session serving this plan is always valid.
    """
    changed = 0
    for entry in plan.entries.values():
        ident = tuple(entry.group)
        if entry.perm != ident:
            entry.perm = ident
            changed += 1
    plan.meta["fallback"] = "identity"
    obs.tracer().event("faults.identity_fallback", changed=changed)
    obs.metrics().counter("faults.identity_fallbacks").inc()
    return changed
