"""Budgeted sparse probing (a copy of ``repro.fabric.sparse``): plan-grade
cost matrices from O(n·log n) probes.

Dense probing (paper §IV-B) measures every directed pair — n(n-1)
probes, the scalability wall the paper names as future work (§VI).  The
hierarchy makes most of those probes redundant: within a recovered
block, costs are statistically exchangeable, and between two blocks
every pair crosses the same bottleneck tier.  So:

1. **Landmark sweep** — probe every node against L = O(log n) landmark
   nodes (n·L probes).  Each node's landmark cost vector is a locality
   embedding: same-rack nodes have near-identical vectors.
2. **Cluster** — agglomerate the embeddings
   (:func:`repro_torch.fabric.hierarchy.infer_hierarchy` on the embedding
   distance matrix) into locality clusters.
3. **Refine** — probe all intra-cluster pairs (clusters are small) plus
   a few representative pairs per cluster pair (medoid-to-medoid and
   random cross members), trimming to the probe budget.
4. **Complete** — unprobed (i, j) entries take the **median** of the
   probed entries between cluster(i) and cluster(j).

The result is a :class:`SparseProbeResult` — a drop-in
:class:`~repro_torch.fabric.probe.ProbeResult` carrying the completed
matrices, the probe count actually spent, and the inferred
:class:`~repro_torch.fabric.hierarchy.HierarchyModel` (re-derived from the
completed matrix, so downstream consumers see one consistent tree).

:func:`refresh_sparse` is the drift path: re-probe each cluster's
representative against the landmarks, and only clusters whose median
cost moved get their pairs re-probed — monitoring cost scales with the
number of *changed* clusters, not with n².
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

from .hierarchy import HierarchyModel, infer_hierarchy
from .probe import ProbeResult, _validate_probe_params
from .topology import Fabric

__all__ = ["SparseProbeResult", "sparse_probe_fabric", "refresh_sparse"]

#: simulated probe-sample population per pair (matches probe_fabric)
_SAMPLES = 16


@dataclasses.dataclass
class SparseProbeResult(ProbeResult):
    """A :class:`ProbeResult` reconstructed from a probe subsample.

    ``lat``/``bw`` are *completed* matrices (cluster-median filled), so
    every dense consumer — cost models, solvers, the plan compiler —
    works unchanged.  The sparse-only artifacts ride along:
    """

    #: locality tree inferred from the completed matrix
    hierarchy: Optional[HierarchyModel] = None
    #: directed probes actually spent (2 per measured undirected pair)
    probes_used: int = 0
    #: the budget the probe was asked to respect (fraction of n(n-1))
    probe_budget: float = 0.25
    #: [n, n] bool — True where the entry was measured, not completed
    observed: Optional[np.ndarray] = None
    #: landmark node ids of the seed sweep (refresh re-uses them)
    landmarks: Tuple[int, ...] = ()

    @property
    def probe_fraction(self) -> float:
        """Directed probes spent / the dense probe's n(n-1)."""
        n = self.n
        return self.probes_used / max(n * (n - 1), 1)

    def subset(self, nodes: Sequence[int]) -> "SparseProbeResult":
        """Restriction to ``nodes``, sparse artifacts included.

        The hierarchy is put through
        :meth:`~repro_torch.fabric.hierarchy.HierarchyModel.restrict` (same
        local re-indexing), the observed mask is sliced, and landmarks
        keep only surviving nodes (remapped) — so
        :func:`refresh_sparse` keeps tracking clusters across an
        elastic membership change instead of restarting from scratch.
        """
        from .probe import _validate_subset

        idx = _validate_subset(nodes, self.n, type(self).__name__)
        members = [int(x) for x in idx]
        local = {node: k for k, node in enumerate(members)}
        return SparseProbeResult(
            lat=self.lat[np.ix_(idx, idx)].copy(),
            bw=None if self.bw is None
            else self.bw[np.ix_(idx, idx)].copy(),
            n_probes=self.n_probes, percentile=self.percentile,
            hierarchy=None if self.hierarchy is None
            else self.hierarchy.restrict(members),
            probes_used=self.probes_used, probe_budget=self.probe_budget,
            observed=None if self.observed is None
            else self.observed[np.ix_(idx, idx)].copy(),
            landmarks=tuple(local[x] for x in self.landmarks
                            if x in local))


# ---------------------------------------------------------------------------
# pair measurement (shared noise model with probe_fabric)
# ---------------------------------------------------------------------------

def _measure_pairs(fabric: Fabric, pairs: np.ndarray, rng: np.random.Generator,
                   percentile: float, noise_scale: float, measure_bw: bool,
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Measured (lat, bw) per undirected pair, MAX/MIN symmetrized.

    Same per-pair pipeline as :func:`repro_torch.fabric.probe.probe_fabric`:
    percentile of exponential queueing noise on each direction, then
    symmetrize (lat with MAX, bw with MIN).
    """
    i, j = pairs[:, 0], pairs[:, 1]
    noise = rng.exponential(noise_scale, size=(len(pairs), 2, _SAMPLES)) \
        if noise_scale > 0 else np.zeros((len(pairs), 2, _SAMPLES))
    pct = np.percentile(noise, percentile, axis=-1)
    lat = np.maximum(fabric.lat[i, j] * (1.0 + pct[:, 0]),
                     fabric.lat[j, i] * (1.0 + pct[:, 1]))
    bw = None
    if measure_bw:
        load = np.clip(rng.normal(0.0, 0.05, size=(len(pairs), 2)),
                       -0.15, 0.3)
        bw = np.minimum(fabric.bw[i, j] * (1.0 - load[:, 0]),
                        fabric.bw[j, i] * (1.0 - load[:, 1]))
    return lat, bw


def _fill_pairs(mat: np.ndarray, pairs: np.ndarray, vals: np.ndarray) -> None:
    mat[pairs[:, 0], pairs[:, 1]] = vals
    mat[pairs[:, 1], pairs[:, 0]] = vals


def _pair_set(pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Dedup + canonicalize (i < j) an undirected pair list."""
    canon = {(min(a, b), max(a, b)) for a, b in pairs if a != b}
    if not canon:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(sorted(canon), dtype=np.int64)


# ---------------------------------------------------------------------------
# cluster selection
# ---------------------------------------------------------------------------

def _embedding_clusters(emb: np.ndarray, landmarks: np.ndarray,
                        max_cluster: int) -> List[List[int]]:
    """Locality clusters from the landmark embedding.

    Agglomerate the embedding distance matrix with the same tier-cut
    machinery as the full hierarchy inference; when no structure
    separates (uniform fabric), fall back to nearest-landmark buckets
    so the refinement stage still has bounded clusters to work with.
    """
    n = emb.shape[0]
    d = np.sqrt(((emb[:, None, :] - emb[None, :, :]) ** 2).mean(axis=-1))
    h = infer_hierarchy(d)
    clusters = [c for c in h.blocks(0)] if not h.flat else []
    if not clusters or max(len(c) for c in clusters) > max_cluster \
            or np.mean([len(c) for c in clusters]) < 2:
        lab = np.argmin(np.abs(emb), axis=1) if len(landmarks) else \
            np.zeros(n, dtype=np.int64)
        buckets: Dict[int, List[int]] = {}
        for node, b in enumerate(lab):
            buckets.setdefault(int(b), []).append(node)
        clusters = list(buckets.values())
    # split any oversized cluster into contiguous halves until bounded
    out: List[List[int]] = []
    stack = [sorted(c) for c in clusters]
    while stack:
        c = stack.pop()
        if len(c) <= max_cluster:
            out.append(c)
        else:
            mid = len(c) // 2
            stack.append(c[:mid])
            stack.append(c[mid:])
    return sorted(out, key=lambda c: c[0])


def _medoid(emb: np.ndarray, members: List[int]) -> int:
    sub = emb[members]
    d = np.abs(sub[:, None, :] - sub[None, :, :]).sum(axis=(1, 2))
    return members[int(np.argmin(d))]


# ---------------------------------------------------------------------------
# completion
# ---------------------------------------------------------------------------

def _complete(mat: np.ndarray, observed: np.ndarray, labels: np.ndarray,
              kind: str) -> np.ndarray:
    """Fill unobserved entries with their cluster-pair median.

    ``kind="lat"``: diagonal 0, symmetrize with MAX (the paper's
    convention); ``kind="bw"``: diagonal inf, symmetrize with MIN.
    Cluster-pair medians are computed in one sorted pass over the
    observed entries (no per-pair python re-slicing).
    """
    n = mat.shape[0]
    k = int(labels.max()) + 1
    pid = labels[:, None] * k + labels[None, :]
    obs = observed & ~np.eye(n, dtype=bool) & np.isfinite(mat)
    vals = mat[obs]
    pids = pid[obs]
    med = np.full(k * k, np.nan)
    g = float(np.median(vals)) if vals.size else 0.0
    if vals.size:
        order = np.argsort(pids, kind="stable")
        sp, sv = pids[order], vals[order]
        uniq, starts = np.unique(sp, return_index=True)
        bounds = np.append(starts, len(sv))
        for u, a, b in zip(uniq, bounds[:-1], bounds[1:]):
            med[u] = np.median(sv[a:b])
    med = np.where(np.isnan(med), g, med)
    out = np.where(obs, mat, med[pid])
    if kind == "lat":
        np.fill_diagonal(out, 0.0)
        return np.maximum(out, out.T)
    np.fill_diagonal(out, np.inf)
    return np.minimum(out, out.T)


# ---------------------------------------------------------------------------
# the sparse probe
# ---------------------------------------------------------------------------

def sparse_probe_fabric(
    fabric: Fabric,
    budget: float = 0.25,
    **kwargs,
) -> SparseProbeResult:
    """Instrumented front-end of :func:`_sparse_probe_fabric` (same
    signature): the sweep runs under an obs timer, feeding the
    ``fabric.probe.seconds`` latency histogram and the probes-used
    gauge that make the sparse budget observable in ``repro status``."""
    timer = obs.tracer().timer("fabric.probe.sparse", n=fabric.n)
    with timer:
        result = _sparse_probe_fabric(fabric, budget=budget, **kwargs)
    m = obs.metrics()
    m.counter("fabric.probe.sweeps").inc()
    m.histogram("fabric.probe.seconds", scale=1e-3).observe(timer.elapsed)
    m.gauge("fabric.probe.sparse.probes_used").set(result.probes_used)
    return result


def _sparse_probe_fabric(
    fabric: Fabric,
    budget: float = 0.25,
    n_probes: int = 1000,
    percentile: float = 10.0,
    noise_scale: float = 0.3,
    seed: int = 0,
    measure_bw: bool = True,
    n_landmarks: Optional[int] = None,
    inter_reps: int = 3,
    fill_budget: bool = True,
) -> SparseProbeResult:
    """Probe ``fabric`` with at most ``budget`` of the dense n(n-1) probes.

    See the module docstring for the four stages.  ``budget`` is a hard
    cap: if full intra-cluster refinement would exceed it, intra pairs
    are subsampled — cluster rings and medoid-medoid anchors are
    trimmed last, so in-block ordering and every cluster-pair median
    stay grounded in real measurements for as long as the budget
    permits.  When the structural stages
    leave budget over, ``fill_budget`` (default) spends it on random
    unobserved pairs — real measurements beat completed ones;
    ``fill_budget=False`` stops at the O(n·log n + K²) structural
    probes, the minimal spend at which completion is still plan-grade.
    Raises :class:`ValueError` on a budget outside (0, 1] or the
    shared probe-parameter violations.
    """
    _validate_probe_params(n_probes, percentile, noise_scale)
    if not 0.0 < budget <= 1.0:
        raise ValueError(
            f"sparse probe budget must be in (0, 1] (fraction of the dense "
            f"n(n-1) directed probes); got {budget}")
    rng = np.random.default_rng(seed)
    n = fabric.n
    max_pairs = int(budget * n * (n - 1)) // 2     # undirected budget
    if n <= 2:
        # nothing to subsample; fall back to measuring the only pair(s)
        max_pairs = max(max_pairs, n - 1)
    elif max_pairs < n - 1:
        raise ValueError(
            f"sparse probe budget {budget} allows only {max_pairs} "
            f"undirected pairs, below the {n - 1} needed to touch every "
            f"node once; raise the budget to at least "
            f"{2 * (n - 1) / (n * (n - 1)):.4f} for n={n}")

    # 1. landmark sweep -----------------------------------------------------
    L = n_landmarks if n_landmarks is not None else \
        max(4, int(np.ceil(2 * np.log2(max(n, 2)))))
    # the sweep may spend at most half the budget; refinement needs the rest
    L = min(L, n - 1, max(1, (max_pairs // 2) // max(n, 1)))
    # the L cap above bounds the sweep at max_pairs // 2 pairs (or at the
    # n-1 spanning star when the budget is that tight, which the
    # validation guaranteed fits), so the sweep never overshoots
    landmarks = np.sort(rng.choice(n, size=max(L, 1), replace=False))
    seed_pairs = _pair_set([(i, int(l)) for l in landmarks for i in range(n)])
    lat = np.zeros((n, n))
    bw = np.full((n, n), np.inf) if measure_bw else None
    observed = np.eye(n, dtype=bool)
    lat_v, bw_v = _measure_pairs(fabric, seed_pairs, rng, percentile,
                                 noise_scale, measure_bw)
    _fill_pairs(lat, seed_pairs, lat_v)
    if bw is not None:
        _fill_pairs(bw, seed_pairs, bw_v)
    observed[seed_pairs[:, 0], seed_pairs[:, 1]] = True
    observed[seed_pairs[:, 1], seed_pairs[:, 0]] = True

    # 2. cluster the landmark embedding ------------------------------------
    emb = lat[:, landmarks]
    max_cluster = max(4, int(np.ceil(np.sqrt(max_pairs))))
    clusters = _embedding_clusters(emb, landmarks, max_cluster)
    labels = np.zeros(n, dtype=np.int64)
    for cid, members in enumerate(clusters):
        labels[members] = cid

    # 3. refinement pairs: intra-cluster + representative inter ------------
    budget_left = max_pairs - len(seed_pairs)
    intra: List[Tuple[int, int]] = []
    for members in clusters:
        m = len(members)
        full = [(members[a], members[b])
                for a in range(m) for b in range(a + 1, m)]
        intra.append(full)
    intra_pairs = [p for block in intra for p in block]
    ring_pairs: List[Tuple[int, int]] = []       # one ring per cluster
    for members in clusters:
        ring_pairs.extend(p for p in zip(members, members[1:] + members[:1])
                          if p[0] != p[1])
    ring_set = {(min(q), max(q)) for q in ring_pairs}
    if len(intra_pairs) > budget_left and budget_left > 0:
        # keep a ring through each cluster, spend the rest on random chords
        keep = list(ring_pairs)
        chords = [p for p in intra_pairs
                  if (min(p), max(p)) not in ring_set]
        extra = max(0, budget_left - len(keep))
        if chords and extra:
            picks = rng.choice(len(chords), size=min(extra, len(chords)),
                               replace=False)
            keep.extend(chords[int(x)] for x in picks)
        if len(keep) > budget_left:      # even the rings exceed budget
            picks = rng.choice(len(keep), size=max(budget_left, 0),
                               replace=False)
            keep = [keep[int(i)] for i in sorted(picks)]
        intra_pairs = keep
    medoids = [_medoid(emb, members) for members in clusters]
    medoid_set = set()
    inter: List[Tuple[int, int]] = []
    for a in range(len(clusters)):
        for b in range(a + 1, len(clusters)):
            m = (medoids[a], medoids[b])
            medoid_set.add((min(m), max(m)))
            inter.append(m)
            for _ in range(max(inter_reps - 1, 0)):
                inter.append((int(rng.choice(clusters[a])),
                              int(rng.choice(clusters[b]))))
    refine = _pair_set(intra_pairs + inter)
    if refine.size:
        new = ~observed[refine[:, 0], refine[:, 1]]
        refine = refine[new]
    if len(refine) > budget_left:
        # load-bearing pairs go last: cluster rings (in-block ordering)
        # and medoid-medoid anchors (every cluster-pair median) survive
        # while random chords and extra inter reps are trimmed
        prio_set = ring_set | medoid_set
        is_prio = np.asarray([(min(p), max(p)) in prio_set
                              for p in map(tuple, refine)])
        prio_idx = np.nonzero(is_prio)[0]
        rest_idx = np.nonzero(~is_prio)[0]
        room = max(budget_left, 0) - len(prio_idx)
        if room >= 0:
            picks = rng.choice(rest_idx.size,
                               size=min(room, int(rest_idx.size)),
                               replace=False) if rest_idx.size and room \
                else np.zeros(0, dtype=np.int64)
            keep_idx = np.concatenate([prio_idx, rest_idx[picks]])
        else:
            sub = rng.choice(prio_idx.size, size=max(budget_left, 0),
                             replace=False)
            keep_idx = prio_idx[sub]
        refine = refine[np.sort(keep_idx.astype(np.int64))]
    if refine.size:
        lat_v, bw_v = _measure_pairs(fabric, refine, rng, percentile,
                                     noise_scale, measure_bw)
        _fill_pairs(lat, refine, lat_v)
        if bw is not None:
            _fill_pairs(bw, refine, bw_v)
        observed[refine[:, 0], refine[:, 1]] = True
        observed[refine[:, 1], refine[:, 0]] = True

    # residual fill: the budget is paid for either way, so spend any
    # remainder on random unobserved (inter-cluster) pairs — at small n
    # the landmark sweep is a big budget fraction and every extra real
    # measurement sharpens the completion medians
    leftover = (max_pairs - len(seed_pairs) - len(refine)) if fill_budget \
        else 0
    if leftover > 0:
        ui, uj = np.nonzero(np.triu(~observed, 1))
        if ui.size:
            picks = rng.choice(ui.size, size=min(leftover, ui.size),
                               replace=False)
            extra = np.stack([ui[picks], uj[picks]], axis=1)
            lat_v, bw_v = _measure_pairs(fabric, extra, rng, percentile,
                                         noise_scale, measure_bw)
            _fill_pairs(lat, extra, lat_v)
            if bw is not None:
                _fill_pairs(bw, extra, bw_v)
            observed[extra[:, 0], extra[:, 1]] = True
            observed[extra[:, 1], extra[:, 0]] = True
        else:
            extra = np.zeros((0, 2), dtype=np.int64)
    else:
        extra = np.zeros((0, 2), dtype=np.int64)

    # 4. complete from cluster medians -------------------------------------
    lat_full = _complete(lat, observed, labels, "lat")
    bw_full = _complete(bw, observed, labels, "bw") if bw is not None else None
    hierarchy = infer_hierarchy(lat_full)
    probes_used = 2 * (len(seed_pairs) + len(refine) + len(extra))
    return SparseProbeResult(
        lat=lat_full, bw=bw_full, n_probes=n_probes, percentile=percentile,
        hierarchy=hierarchy, probes_used=probes_used, probe_budget=budget,
        observed=observed, landmarks=tuple(int(x) for x in landmarks))


# ---------------------------------------------------------------------------
# cluster-scoped refresh (the drift monitor's probe path)
# ---------------------------------------------------------------------------

def refresh_sparse(
    fabric: Fabric,
    prev: SparseProbeResult,
    seed: int = 0,
    moved_tol_octaves: float = 0.5,
    percentile: float = 10.0,
    noise_scale: float = 0.3,
    measure_bw: bool = True,
) -> Tuple[SparseProbeResult, List[int]]:
    """Re-probe only the clusters that moved since ``prev``.

    Each cluster's medoid is re-probed against the stored landmarks
    (O(K·L) probes); a cluster whose median landmark cost moved by more
    than ``moved_tol_octaves`` gets all of its previously observed
    pairs re-measured.  Returns the refreshed result (``probes_used``
    counts only this refresh) and the moved cluster ids.
    """
    if getattr(prev, "hierarchy", None) is None \
            or getattr(prev, "observed", None) is None \
            or not getattr(prev, "landmarks", ()):
        raise ValueError(
            "refresh_sparse needs a SparseProbeResult from "
            "sparse_probe_fabric (with hierarchy, observed mask, and "
            "landmarks); re-probe from scratch instead")
    rng = np.random.default_rng(seed)
    n = fabric.n
    landmarks = np.asarray(prev.landmarks, dtype=np.int64)
    clusters = prev.hierarchy.blocks(0)
    labels = prev.hierarchy.labels(0)
    emb_prev = prev.lat[:, landmarks]
    medoids = [_medoid(emb_prev, list(members)) for members in clusters]

    # 1. cheap sentinel sweep: medoid -> landmarks
    sentinel = _pair_set([(m, int(l)) for m in medoids for l in landmarks])
    lat_s, _ = _measure_pairs(fabric, sentinel, rng, percentile,
                              noise_scale, False)
    probe_count = len(sentinel)
    fresh = np.full((n, n), np.nan)
    _fill_pairs(fresh, sentinel, lat_s)

    moved: List[int] = []
    for cid, medoid in enumerate(medoids):
        now = np.asarray([fresh[medoid, l] for l in landmarks if l != medoid])
        ref = np.asarray([prev.lat[medoid, l] for l in landmarks
                          if l != medoid])
        ok = np.isfinite(now) & (now > 0) & (ref > 0)
        if not ok.any():
            continue
        shift = abs(float(np.log2(np.median(now[ok]) /
                                  np.median(ref[ok]))))
        if shift > moved_tol_octaves:
            moved.append(cid)

    lat = prev.lat.copy()
    bw = prev.bw.copy() if prev.bw is not None else None
    observed = prev.observed.copy()
    if moved:
        moved_mask = np.isin(labels, moved)
        touch = observed & (moved_mask[:, None] | moved_mask[None, :]) \
            & ~np.eye(n, dtype=bool)
        ii, jj = np.nonzero(np.triu(touch, 1))
        pairs = np.stack([ii, jj], axis=1)
        lat_v, bw_v = _measure_pairs(fabric, pairs, rng, percentile,
                                     noise_scale, measure_bw and bw is not None)
        _fill_pairs(lat, pairs, lat_v)
        if bw is not None and bw_v is not None:
            _fill_pairs(bw, pairs, bw_v)
        probe_count += len(pairs)
        # re-complete the moved rows/cols from the refreshed medians
        lat = _complete(np.where(observed, lat, 0.0), observed, labels, "lat")
        if bw is not None:
            bw = _complete(np.where(observed, bw, np.inf), observed,
                           labels, "bw")
    hierarchy = infer_hierarchy(lat) if moved else prev.hierarchy
    m = obs.metrics()
    m.counter("fabric.refresh.ticks").inc()
    if moved:
        m.counter("fabric.refresh.moved_clusters").inc(len(moved))
        obs.tracer().event("fabric.refresh.moved", clusters=list(moved),
                           probes=2 * probe_count)
    return SparseProbeResult(
        lat=lat, bw=bw, n_probes=prev.n_probes, percentile=percentile,
        hierarchy=hierarchy, probes_used=2 * probe_count,
        probe_budget=prev.probe_budget, observed=observed,
        landmarks=prev.landmarks), moved
