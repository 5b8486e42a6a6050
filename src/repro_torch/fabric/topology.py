"""Synthetic network fabrics: hierarchical datacenters and TPU fleets.

The paper's setting is a multi-tenant hierarchical datacenter whose
pairwise VM-to-VM cost is non-uniform and hidden from the tenant.  This
module generates such fabrics so every algorithmic layer (probing, cost
models, solvers, simulator) can be exercised without cloud access:

* :func:`make_datacenter` — classic 3-tier Clos (node -> ToR -> agg ->
  spine) with oversubscription and per-link multi-tenant congestion.
* :func:`make_tpu_fleet` — one or more TPU pods; intra-pod 2D torus ICI,
  inter-pod DCN through datacenter tiers.  This is the adaptation
  target: the ``pod`` mesh axis of a multi-pod JAX job rides on DCN.
* :func:`scramble` — random node relabeling: models the "randomly ordered
  IP list" a tenant gets from the provider (paper §I).

All links are **full duplex**: each physical link contributes separate
up/down directed link ids, so a chunked ring (every node sends and
receives concurrently) does not self-contend on NICs.

A :class:`Fabric` carries everything downstream layers need:

* ``lat[i, j]``   — base one-way latency seconds between endpoints,
* ``bw[i, j]``    — bottleneck bandwidth bytes/s of the path (no contention),
* ``paths[i][j]`` — tuple of directed link ids the path traverses (for the
  contention-aware simulator),
* ``link_bw[l]``  — capacity of each directed link id.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .costs import combine_cost

__all__ = [
    "Fabric",
    "make_datacenter",
    "make_tpu_fleet",
    "scramble",
]


@dataclasses.dataclass
class Fabric:
    """A network fabric between ``n`` endpoints (VMs or TPU chips)."""

    n: int
    lat: np.ndarray                       # [n, n] seconds, 0 on diagonal
    bw: np.ndarray                        # [n, n] bytes/s, inf on diagonal
    paths: List[List[Tuple[int, ...]]]    # paths[i][j] -> directed link ids
    link_bw: np.ndarray                   # [n_links] bytes/s
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        assert self.lat.shape == (self.n, self.n)
        assert self.bw.shape == (self.n, self.n)

    def cost_matrix(self, size_bytes: float = 0.0) -> np.ndarray:
        """Paper-style pairwise cost c_{i,j}(S) = latency + S / bandwidth.

        The paper uses a latency-centric cost (§IV-B, TCP throughput ~
        MSS / (RTT sqrt(p))): ``size_bytes=0`` (default) reproduces that.
        On TPU fabrics the bandwidth term matters for multi-MB payloads,
        so callers there pass the real payload.
        """
        return combine_cost(self.lat, self.bw, size_bytes)

    def subset(self, nodes: Sequence[int]) -> "Fabric":
        """Fabric restricted to ``nodes`` (elastic restart after failure).

        Raises :class:`ValueError` on empty, out-of-range, or duplicate
        node ids — a wrong survivor list must fail loudly here, not as a
        numpy index error deep inside a solver.
        """
        nodes = [int(x) for x in nodes]
        if not nodes:
            raise ValueError(
                "Fabric.subset needs at least one node; got an empty list")
        bad = [x for x in nodes if x < 0 or x >= self.n]
        if bad:
            raise ValueError(
                f"Fabric.subset node ids {bad} out of range for a fabric of "
                f"{self.n} nodes (valid ids: 0..{self.n - 1})")
        if len(set(nodes)) != len(nodes):
            dups = sorted({x for x in nodes if nodes.count(x) > 1})
            raise ValueError(
                f"Fabric.subset node ids must be unique; duplicates: {dups}")
        idx = np.asarray(nodes)
        paths = [[self.paths[i][j] for j in nodes] for i in nodes]
        return Fabric(
            n=len(nodes),
            lat=self.lat[np.ix_(idx, idx)].copy(),
            bw=self.bw[np.ix_(idx, idx)].copy(),
            paths=paths,
            link_bw=self.link_bw.copy(),
            meta=dict(self.meta, parent_nodes=nodes),
        )


class _LinkTable:
    def __init__(self) -> None:
        self.bw: List[float] = []
        self.lat: List[float] = []

    def add(self, bw_bytes: float, lat_s: float) -> int:
        self.bw.append(bw_bytes)
        self.lat.append(lat_s)
        return len(self.bw) - 1

    def add_duplex(self, bw_bytes: float, lat_s: float) -> Tuple[int, int]:
        return self.add(bw_bytes, lat_s), self.add(bw_bytes, lat_s)


def _assemble(
    n: int,
    chains: List[List[Tuple[int, int]]],  # per node: [(up_id, down_id), ...]
    links: _LinkTable,
    meta: Dict[str, object],
) -> Fabric:
    """Build a Fabric from per-node duplex uplink chains.

    The path i -> j walks i's *up* directions to the lowest common level,
    then j's *down* directions back out.
    """
    lat = np.zeros((n, n))
    bw = np.full((n, n), np.inf)
    link_bw = np.asarray(links.bw, dtype=np.float64)
    link_lat = np.asarray(links.lat, dtype=np.float64)
    paths: List[List[Tuple[int, ...]]] = [[() for _ in range(n)] for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            ci, cj = chains[i], chains[j]
            k = 0
            while (
                k < min(len(ci), len(cj))
                and ci[len(ci) - 1 - k] == cj[len(cj) - 1 - k]
            ):
                k += 1
            ups = [u for (u, _) in ci[: len(ci) - k]]
            downs = [d for (_, d) in reversed(cj[: len(cj) - k])]
            path = tuple(ups + downs)
            paths[i][j] = path
            lat[i, j] = float(link_lat[list(path)].sum()) if path else 0.0
            bw[i, j] = float(link_bw[list(path)].min()) if path else np.inf
    return Fabric(n=n, lat=lat, bw=bw, paths=paths, link_bw=link_bw, meta=meta)


def make_datacenter(
    n_nodes: int,
    nodes_per_rack: int = 8,
    racks_per_agg: int = 4,
    oversub: float = 4.0,
    nic_gbps: float = 12.5,
    tenancy_load: float = 0.4,
    heavy_tail: float = 0.8,
    seed: int = 0,
) -> Fabric:
    """3-tier Clos datacenter with multi-tenant congestion (paper §II-A).

    * node -> ToR: dedicated full-duplex NIC (not shared; "VMs within the
      same rack have the best and stable performance").
    * ToR -> agg: oversubscribed by ``oversub``; multi-tenant load both
      cuts capacity and adds queueing latency.
    * agg -> spine: further oversubscribed, highest queueing.

    Latency ranges match the paper's Fig. 2 heatmap: intra-rack a few µs,
    cross-agg tens to hundreds of µs depending on load.
    """
    rng = np.random.default_rng(seed)
    n_racks = -(-n_nodes // nodes_per_rack)
    n_aggs = -(-n_racks // racks_per_agg)
    nic = nic_gbps * 1e9  # GB/s -> bytes/s

    links = _LinkTable()

    def congestion() -> Tuple[float, float]:
        """(capacity keep-fraction, latency multiplier) for a shared link.

        Multi-tenant queueing is heavy-tailed (noisy neighbors): a
        lognormal latency factor gives most links a mild penalty and a
        few links a 10-30x one — the regime behind the paper's Fig. 1
        wide performance distribution.
        """
        load = rng.beta(2.0, 2.0 / max(tenancy_load, 1e-3) - 2.0)
        tail = float(np.exp(rng.normal(0.0, heavy_tail)))
        return (1.0 - 0.8 * load) / (1.0 + 0.3 * (tail - 1.0)), (1.0 + 10.0 * load) * tail

    tor_up: List[Tuple[int, int]] = []
    for _ in range(n_racks):
        keep, lat_mult = congestion()
        cap = nic * nodes_per_rack / oversub * keep
        tor_up.append(links.add_duplex(cap, 5e-6 * lat_mult))
    agg_up: List[Tuple[int, int]] = []
    for _ in range(n_aggs):
        keep, lat_mult = congestion()
        cap = nic * nodes_per_rack * racks_per_agg / (oversub * 2.0) * keep
        agg_up.append(links.add_duplex(cap, 15e-6 * lat_mult))

    chains: List[List[Tuple[int, int]]] = []
    for i in range(n_nodes):
        rack = i // nodes_per_rack
        agg = rack // racks_per_agg
        l_nic = links.add_duplex(
            nic * (1.0 - 0.2 * rng.beta(2, 8)), 1.5e-6 * (1.0 + rng.random())
        )
        chains.append([l_nic, tor_up[rack], agg_up[agg]])

    return _assemble(
        n_nodes, chains, links,
        meta={
            "kind": "datacenter", "n_racks": n_racks, "n_aggs": n_aggs,
            "nodes_per_rack": nodes_per_rack, "seed": seed,
        },
    )


def make_tpu_fleet(
    n_pods: int = 2,
    pod_shape: Tuple[int, int] = (16, 16),
    ici_gbps: float = 50.0,
    ici_hop_lat: float = 1e-6,
    dcn_gbps_per_host: float = 25.0,
    dcn_lat: float = 25e-6,
    fragmentation: float = 0.0,
    seed: int = 0,
) -> Fabric:
    """TPU fleet: per-pod 2D torus ICI, DCN between pods.

    Intra-pod chip-to-chip cost follows torus hop distance (placement of a
    logical rank inside the pod matters — the intra-pod analogue of the
    paper's locality).  ``fragmentation`` > 0 randomly degrades a fraction
    of ICI links, modeling partial/fragmented slice allocations.

    Inter-pod traffic leaves through per-host DCN NICs (4 chips/host) into
    pod-edge routers and a shared spine; DCN links carry multi-tenant load.
    """
    rng = np.random.default_rng(seed)
    px, py = pod_shape
    chips_per_pod = px * py
    n = n_pods * chips_per_pod
    ici_bw = ici_gbps * 1e9
    dcn_bw = dcn_gbps_per_host * 1e9

    links = _LinkTable()

    # --- torus links: one duplex pair per (pod, x, y, axis) -------------
    torus_link: Dict[Tuple[int, int, int, int], Tuple[int, int]] = {}
    for p in range(n_pods):
        for x in range(px):
            for y in range(py):
                for axis in (0, 1):
                    degrade = 1.0
                    if fragmentation and rng.random() < fragmentation:
                        degrade = 0.25 + 0.5 * rng.random()
                    torus_link[(p, x, y, axis)] = links.add_duplex(
                        ici_bw * degrade, ici_hop_lat
                    )

    # --- DCN: host NIC -> pod edge -> spine ------------------------------
    spine = links.add_duplex(dcn_bw * n / 4 / 3.0, 10e-6)
    pod_edge = []
    for _ in range(n_pods):
        load = rng.beta(2, 6)
        pod_edge.append(
            links.add_duplex(dcn_bw * chips_per_pod / 4 / 2.0 * (1 - 0.6 * load), 8e-6)
        )
    host_nic = []
    for _ in range(n // 4):
        load = rng.beta(2, 8)
        host_nic.append(
            links.add_duplex(dcn_bw * (1 - 0.5 * load), dcn_lat * (0.8 + 0.4 * rng.random()))
        )

    def chip_id(p: int, x: int, y: int) -> int:
        return p * chips_per_pod + x * py + y

    def torus_path(p: int, xa: int, ya: int, xb: int, yb: int) -> Tuple[int, ...]:
        """X-then-Y dimension-ordered routing with wraparound; directed."""
        out: List[int] = []
        x = xa
        dx = (xb - xa) % px
        step = 1 if dx <= px // 2 else -1
        while x != xb:
            nx = (x + step) % px
            lo = min(x, nx) if abs(x - nx) == 1 else max(x, nx)
            duplex = torus_link[(p, lo, ya, 0)]
            out.append(duplex[0] if step == 1 else duplex[1])
            x = nx
        y = ya
        dy = (yb - ya) % py
        step = 1 if dy <= py // 2 else -1
        while y != yb:
            ny = (y + step) % py
            lo = min(y, ny) if abs(y - ny) == 1 else max(y, ny)
            duplex = torus_link[(p, xb, lo, 1)]
            out.append(duplex[0] if step == 1 else duplex[1])
            y = ny
        return tuple(out)

    lat = np.zeros((n, n))
    bw = np.full((n, n), np.inf)
    link_bw = np.asarray(links.bw)
    link_lat = np.asarray(links.lat)
    paths: List[List[Tuple[int, ...]]] = [[() for _ in range(n)] for _ in range(n)]

    for p in range(n_pods):
        for xa in range(px):
            for ya in range(py):
                a = chip_id(p, xa, ya)
                for xb in range(px):
                    for yb in range(py):
                        b = chip_id(p, xb, yb)
                        if a == b:
                            continue
                        path = torus_path(p, xa, ya, xb, yb)
                        paths[a][b] = path
                        lat[a, b] = float(link_lat[list(path)].sum())
                        bw[a, b] = float(link_bw[list(path)].min())

    for a in range(n):
        pa = a // chips_per_pod
        for b in range(n):
            pb = b // chips_per_pod
            if a == b or pa == pb:
                continue
            path = (
                host_nic[a // 4][0], pod_edge[pa][0], spine[0],
                pod_edge[pb][1], host_nic[b // 4][1],
            )
            paths[a][b] = path
            lat[a, b] = float(link_lat[list(path)].sum())
            bw[a, b] = float(link_bw[list(path)].min())

    return Fabric(
        n=n, lat=lat, bw=bw, paths=paths, link_bw=link_bw,
        meta={
            "kind": "tpu_fleet", "n_pods": n_pods, "pod_shape": pod_shape,
            "chips_per_pod": chips_per_pod, "seed": seed,
            "ici_gbps": ici_gbps, "dcn_gbps_per_host": dcn_gbps_per_host,
        },
    )


def scramble(fabric: Fabric, seed: int = 0) -> Tuple[Fabric, np.ndarray]:
    """Randomly relabel nodes: the tenant's 'random IP list' (paper §I).

    Returns ``(scrambled, hidden)`` where ``hidden[new_id] = old_id``.
    A solver working on the scrambled fabric should rediscover locality
    without ever seeing ``hidden``.
    """
    rng = np.random.default_rng(seed)
    hidden = rng.permutation(fabric.n)
    paths = [
        [fabric.paths[hidden[i]][hidden[j]] for j in range(fabric.n)]
        for i in range(fabric.n)
    ]
    return (
        Fabric(
            n=fabric.n,
            lat=fabric.lat[np.ix_(hidden, hidden)].copy(),
            bw=fabric.bw[np.ix_(hidden, hidden)].copy(),
            paths=paths,
            link_bw=fabric.link_bw.copy(),
            meta=dict(fabric.meta, scrambled=True),
        ),
        hidden,
    )
