"""Static contention analysis: per-round link-load histograms.

Three fidelity levels, picked by what the caller can supply:

* a :class:`repro_torch.fabric.Fabric` — exact: every flow's bytes are charged
  to the directed link ids on its path, a round's static bound is the
  most-loaded link's ``bytes / capacity`` (a true lower bound on the
  simulator's max-min fair round time), and links whose load is a
  multiple of the largest single flow crossing them are flagged
  oversubscribed;
* a :class:`repro_torch.fabric.HierarchyModel` — structural: each inferred
  block at each tier owns one logical uplink, flows crossing the block
  boundary load it, and the report shows per-tier crossing histograms
  plus the worst block imbalance (no capacities, so no time bound);
* bare ``(lat, bw)`` probe matrices — pairwise only: the per-round
  bound reuses :func:`repro_torch.fabric.costs.combine_cost` per flow (the one
  shared c_{i,j}(S) formula) with per-rank NIC serialization, matching
  what a live fleet can know without path visibility.

The congestion report this pass assembles is exactly what the
simulator would tell you after running the program — obtained without
running it, which is the point: the plan compiler can surface "this
candidate hammers one uplink" before spending oracle time on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.collective.ir import Program
from repro_torch.fabric import Fabric, HierarchyModel
from repro_torch.fabric.costs import combine_cost

from .report import Finding, finding

__all__ = ["analyze_contention", "link_loads"]

PASS = "contention"


def link_loads(program: Program,
               fabric: Fabric) -> List[Dict[int, Tuple[float, int]]]:
    """Per base round: ``{directed link id: (bytes, n_flows)}``.

    Node-space flows of ONE pipeline piece; with ``chunk_factor`` k the
    body repeats k times, so totals scale back to full payload.
    """
    out: List[Dict[int, Tuple[float, int]]] = []
    for rnd in program.piece_flows():
        loads: Dict[int, Tuple[float, int]] = {}
        for f in rnd:
            if f.src == f.dst:
                continue
            for l in fabric.paths[f.src][f.dst]:
                b, k = loads.get(l, (0.0, 0))
                loads[l] = (b + f.size, k + 1)
        out.append(loads)
    return out


def _fabric_contention(program: Program, fabric: Fabric,
                       oversub_threshold: float):
    findings: List[Finding] = []
    per_round = link_loads(program, fabric)
    piece = program.piece_flows()
    k = program.chunk_factor
    total_load: Dict[int, float] = {}
    rounds_summary: List[Dict[str, object]] = []
    total_bound = 0.0
    for r_i, loads in enumerate(per_round):
        if not loads:
            continue
        bound, bottleneck, worst_share = 0.0, None, 0.0
        for l, (bytes_l, n_flows) in loads.items():
            total_load[l] = total_load.get(l, 0.0) + bytes_l * k
            t = bytes_l / max(float(fabric.link_bw[l]), 1.0)
            if t > bound:
                bound, bottleneck = t, l
            if n_flows > 1:
                # serialization factor: how many max-size flows deep
                # the link's queue is (2.0 = pure 2x oversubscription)
                share = bytes_l / max(
                    max(f.size for f in piece[r_i]
                        if l in fabric.paths[f.src][f.dst]), 1e-30)
                worst_share = max(worst_share, share)
                if share >= oversub_threshold:
                    findings.append(finding(
                        PASS, "OVERSUBSCRIBED_LINK", "info",
                        f"round {r_i}: link {l} carries {n_flows} flows "
                        f"({bytes_l:.0f} bytes, {share:.1f}x the largest "
                        f"single flow) — serialization dominates the round",
                        round=r_i, link=l, n_flows=n_flows,
                        share=round(share, 2)))
        total_bound += bound
        rounds_summary.append({
            "round": r_i, "bottleneck_link": bottleneck,
            "bound_s": bound, "max_share": round(worst_share, 2),
            "links_used": len(loads),
        })
    bottleneck_link = None
    if total_load:
        bottleneck_link = max(
            total_load,
            key=lambda l: total_load[l] / max(float(fabric.link_bw[l]), 1.0))
    stats: Dict[str, object] = {
        "mode": "fabric",
        "static_bound_s": total_bound * k,
        "bottleneck_link": bottleneck_link,
        "bottleneck_bytes": total_load.get(bottleneck_link, 0.0),
        "n_links_used": len(total_load),
        "rounds": rounds_summary,
        "link_histogram": {
            str(l): total_load[l]
            for l in sorted(total_load, key=total_load.get, reverse=True)[:16]
        },
    }
    return findings, stats


def _hierarchy_contention(program: Program, hierarchy: HierarchyModel,
                          oversub_threshold: float):
    findings: List[Finding] = []
    # node ids in the program are rank placements over op.group; the
    # hierarchy indexes global nodes, so restrict it to the group
    group = sorted(program.op.group)
    sub = hierarchy.restrict(group) if hierarchy.n != len(group) or \
        list(range(hierarchy.n)) != group else hierarchy
    pos = {node: i for i, node in enumerate(group)}
    tiers: List[Dict[str, object]] = []
    worst_imbalance = 0.0
    for t in range(sub.n_tiers):
        labels = sub.labels(t)
        uplink: Dict[int, float] = {}
        crossings = 0
        for rnd in program.piece_flows():
            for f in rnd:
                a, b = labels[pos[f.src]], labels[pos[f.dst]]
                if a != b:
                    crossings += 1
                    uplink[int(a)] = uplink.get(int(a), 0.0) + f.size
                    uplink[int(b)] = uplink.get(int(b), 0.0) + f.size
        if not uplink:
            tiers.append({"tier": t, "crossings": 0})
            continue
        loads = np.asarray(list(uplink.values()))
        imbalance = float(loads.max() / max(loads.mean(), 1e-30))
        worst_imbalance = max(worst_imbalance, imbalance)
        tiers.append({
            "tier": t, "crossings": crossings,
            "blocks_loaded": len(uplink),
            "max_uplink_bytes": float(loads.max()) * program.chunk_factor,
            "mean_uplink_bytes": float(loads.mean()) * program.chunk_factor,
            "imbalance": round(imbalance, 2),
        })
        if imbalance >= oversub_threshold:
            findings.append(finding(
                PASS, "UPLINK_IMBALANCE", "info",
                f"tier {t}: the busiest block uplink carries "
                f"{imbalance:.1f}x the mean ({loads.max():.0f} bytes) — "
                f"the rank order concentrates cross-block traffic",
                tier=t, imbalance=round(imbalance, 2)))
    stats: Dict[str, object] = {
        "mode": "hierarchy",
        "tiers": tiers,
        "worst_imbalance": round(worst_imbalance, 2),
    }
    return findings, stats


def _pairwise_contention(program: Program, lat: np.ndarray,
                         bw: Optional[np.ndarray]):
    # the shared c_{i,j}(S) formula at unit payload gives per-byte pair
    # costs; each flow is priced at its own size, each round at the max
    # of its slowest flow and its busiest NIC
    c_unit = combine_cost(lat, bw, 1.0)
    base_lat = combine_cost(lat, None, 0.0)
    total = 0.0
    for rnd in program.piece_flows():
        nic: Dict[int, float] = {}
        slowest = 0.0
        for f in rnd:
            if f.src == f.dst:
                continue
            per_byte = c_unit[f.src, f.dst] - base_lat[f.src, f.dst]
            slowest = max(slowest,
                          base_lat[f.src, f.dst] + per_byte * f.size)
            nic[f.src] = nic.get(f.src, 0.0) + per_byte * f.size
        total += max(slowest, max(nic.values(), default=0.0))
    stats: Dict[str, object] = {
        "mode": "pairwise",
        "static_bound_s": total * program.chunk_factor,
    }
    return [], stats


def analyze_contention(
    program: Program,
    fabric: Optional[Fabric] = None,
    hierarchy: Optional[HierarchyModel] = None,
    lat: Optional[np.ndarray] = None,
    bw: Optional[np.ndarray] = None,
    oversub_threshold: float = 2.0,
) -> Tuple[List[Finding], Dict[str, object]]:
    """Congestion report at the best fidelity the inputs allow."""
    if fabric is not None:
        return _fabric_contention(program, fabric, oversub_threshold)
    if hierarchy is not None and not hierarchy.flat:
        return _hierarchy_contention(program, hierarchy, oversub_threshold)
    if lat is not None:
        return _pairwise_contention(program, np.asarray(lat), bw)
    return [], {"mode": "none"}
