"""Flow-level network simulator: the "real cloud" oracle.

The paper validates its cost model against measured collectives on
Azure/EC2 (Table I).  Offline we need a ground truth that is *richer* than
the cost model, so correlation numbers are meaningful rather than
tautological.  This simulator models what the latency-only cost model
does not:

* per-link **contention**: concurrent flows sharing a link get a max-min
  fair share (progressive filling);
* hierarchical paths from :class:`repro_torch.fabric.topology.Fabric`;
* optional stochastic jitter (multi-tenant background traffic).

Time for one round = completion time of its slowest flow; rounds are
barriers.  This matches how Gloo/NCCL ring/tree phases synchronize and is
the standard flow-level abstraction used by SimAI-style simulators.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .schedule import Flow
from repro_torch.fabric.topology import Fabric

__all__ = ["simulate_rounds", "simulate_collective", "CollectiveSimulator"]

#: the collective kind each algorithm name simulates (a copy of
#: ``repro.core.schedule._SHIM_KINDS``); any other registered builder
#: simulates its first declared kind
_SHIM_KINDS = {
    "ring": "allreduce",
    "ring_sequential": "allreduce",
    "halving_doubling": "allreduce",
    "double_binary_tree": "allreduce",
    "bcube": "allreduce",
    "ring_all_gather": "all_gather",
    "recursive_doubling": "all_gather",
    "all_to_all": "all_to_all",
}


def _fair_share_rates(fabric: Fabric, flows: Sequence[Flow]) -> np.ndarray:
    """Max-min fair rates (bytes/s) via progressive filling.

    Classic water-filling: repeatedly find the most-congested unfrozen
    link, freeze its flows at the equal share, remove capacity, repeat.
    """
    n_flows = len(flows)
    rates = np.zeros(n_flows)
    active = [i for i, f in enumerate(flows) if f.src != f.dst]
    link_cap: Dict[int, float] = {}
    link_flows: Dict[int, List[int]] = {}
    for i in active:
        f = flows[i]
        for l in fabric.paths[f.src][f.dst]:
            link_cap.setdefault(l, float(fabric.link_bw[l]))
            link_flows.setdefault(l, []).append(i)
    frozen = np.zeros(n_flows, dtype=bool)
    # Flows with no links (e.g. same-host) get infinite rate.
    for i in active:
        f = flows[i]
        if not fabric.paths[f.src][f.dst]:
            rates[i] = np.inf
            frozen[i] = True
    for _ in range(len(link_cap) + 1):
        best_l, best_share = None, np.inf
        for l, fl in link_flows.items():
            live = [i for i in fl if not frozen[i]]
            if not live:
                continue
            share = link_cap[l] / len(live)
            if share < best_share:
                best_share, best_l = share, l
        if best_l is None:
            break
        for i in link_flows[best_l]:
            if frozen[i]:
                continue
            rates[i] = best_share
            frozen[i] = True
            f = flows[i]
            for l2 in fabric.paths[f.src][f.dst]:
                if l2 != best_l:
                    link_cap[l2] -= best_share
        link_flows.pop(best_l)
    return rates


def simulate_rounds(
    fabric: Fabric,
    rounds: Sequence[Sequence[Flow]],
    rng: Optional[np.random.Generator] = None,
    jitter: float = 0.0,
) -> float:
    """Total seconds to execute the schedule (rounds are barriers)."""
    total = 0.0
    for flows in rounds:
        flows = [f for f in flows if f.src != f.dst]
        if not flows:
            continue
        rates = _fair_share_rates(fabric, flows)
        t = 0.0
        for f, r in zip(flows, rates):
            lat = fabric.lat[f.src, f.dst]
            xfer = 0.0 if np.isinf(r) else f.size / max(r, 1.0)
            ft = lat + xfer
            if rng is not None and jitter > 0:
                ft *= 1.0 + jitter * rng.exponential()
            t = max(t, ft)
        total += t
    return total


def simulate_collective(
    fabric: Fabric,
    algo: str,
    perm: Sequence[int],
    size_bytes: float,
    seed: Optional[int] = None,
    jitter: float = 0.0,
    **kwargs,
) -> float:
    """Simulate one collective of ``size_bytes`` under rank order ``perm``.

    ``algo`` names a registered :mod:`repro_torch.collective` builder; the
    schedule is compiled through the typed IR (this function stays a
    supported oracle API).
    """
    from repro_torch.collective import CollectiveOp, apply_permutation, compile_op

    perm = [int(p) for p in perm]
    kind = _SHIM_KINDS.get(algo)
    if kind is None:
        from repro_torch.collective import get_builder

        kind = get_builder(algo).kinds[0]    # ValueError on unknown algo
    prog = apply_permutation(
        compile_op(CollectiveOp(kind, float(size_bytes), sorted(perm)),
                   algo, **kwargs),
        perm)
    rng = np.random.default_rng(seed) if seed is not None else None
    return simulate_rounds(fabric, prog.to_flows(), rng=rng, jitter=jitter)


class CollectiveSimulator:
    """Convenience wrapper binding a fabric + algorithm + payload."""

    def __init__(self, fabric: Fabric, algo: str, size_bytes: float, **kwargs):
        self.fabric = fabric
        self.algo = algo
        self.size_bytes = size_bytes
        self.kwargs = kwargs

    def run(self, perm: Sequence[int], seed: Optional[int] = None, jitter: float = 0.0) -> float:
        return simulate_collective(
            self.fabric, self.algo, perm, self.size_bytes,
            seed=seed, jitter=jitter, **self.kwargs,
        )

    def run_many(
        self, perms: Sequence[Sequence[int]], seed: Optional[int] = None, jitter: float = 0.0
    ) -> np.ndarray:
        return np.asarray(
            [self.run(p, seed=None if seed is None else seed + i, jitter=jitter)
             for i, p in enumerate(perms)]
        )
