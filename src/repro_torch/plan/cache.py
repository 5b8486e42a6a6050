"""Fingerprint-keyed plan cache with drift-based invalidation (a copy of
``repro.plan.cache``).

**Fingerprinting.**  A plan's rank permutations refer to concrete node
ids, so the fingerprint must be *order-sensitive* (a re-scrambled IP
list must not hit a stale plan) yet *noise-robust* (re-probing the same
fabric must hit the cache).  Exact hashing of quantized costs is
boundary-brittle — with n^2 elements some always sit on a bin edge — so
:func:`fabric_fingerprint` builds a **sketch**: per-node log2 row
medians (order-sensitive, median-of-n is stable under per-pair probe
noise) plus the global log2 percentile profile (shape of the cost
distribution).  Cache lookups match sketches fuzzily
(:meth:`FabricFingerprint.matches`, max component distance below
``tol`` octaves); the exact ``digest`` — a coarse hash — is only an id
for filenames and logs.

**Cache.**  :class:`PlanCache` is a thread-safe in-memory LRU over
(fingerprint, request key) with an optional JSON directory store:
entries persist across processes as one self-describing file per plan
(the serialized :class:`~repro_torch.plan.compiler.Plan` embeds its
fingerprint, so the store can be re-matched fuzzily after reload).

**Drift.**  :class:`DriftMonitor` wires invalidation to
:class:`repro_torch.core.dynamic.AdaptiveReranker`: one reranker per plan
entry watches refreshed cost matrices (re-probes, TCP_INFO-style
monitoring, straggler detectors); when an entry's order degrades past
the reranker threshold, the monitor patches the entry with the
reranker's bottleneck-swap repair (cheap hot fix) and invalidates the
cached plan so the next request recompiles from scratch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.cost_models import make_cost_model
from repro_torch.core.dynamic import AdaptiveReranker

from repro_torch.collective import get_builder

from .compiler import EntryKey, Plan, PlanEntry

__all__ = [
    "FabricFingerprint",
    "fabric_fingerprint",
    "PlanCache",
    "DriftMonitor",
    "DriftReport",
]

#: Default fuzzy-match tolerance in octaves.  Probe noise moves row
#: log-medians by ~0.01 octaves; real structural change (a congested
#: link, a relabeled node) moves them by >= 1.
DEFAULT_TOL = 0.25

_PCTS = (5.0, 25.0, 50.0, 75.0, 95.0)


@dataclasses.dataclass(frozen=True)
class FabricFingerprint:
    """Noise-robust, order-sensitive sketch of a probed cost matrix."""

    n: int
    sketch: Tuple[float, ...]   # [n row log-medians, len(_PCTS) profile terms]
    digest: str                 # coarse stable id (filenames / logs only)

    def matches(self, other: "FabricFingerprint", tol: float = DEFAULT_TOL) -> bool:
        if not isinstance(other, FabricFingerprint) or self.n != other.n:
            return False
        if len(self.sketch) != len(other.sketch):
            return False
        a = np.asarray(self.sketch)
        b = np.asarray(other.sketch)
        return bool(np.max(np.abs(a - b)) < tol)

    def to_dict(self) -> dict:
        return {"n": self.n, "sketch": list(self.sketch), "digest": self.digest}

    @staticmethod
    def from_dict(d: dict) -> "FabricFingerprint":
        return FabricFingerprint(
            n=int(d["n"]),
            sketch=tuple(float(x) for x in d["sketch"]),
            digest=str(d["digest"]),
        )


def _bw_part(bw: Optional[np.ndarray], n: int) -> np.ndarray:
    """Per-node log2 row medians of the bandwidth matrix (vs their own
    median) — shared by the dense and tree sketches."""
    if bw is None or n <= 1:
        return np.zeros(0)
    b = np.asarray(bw, dtype=np.float64)
    rows = []
    for i in range(n):
        v = np.delete(b[i], i)
        v = v[np.isfinite(v) & (v > 0)]
        rows.append(float(np.median(v)) if v.size else np.nan)
    row_bw = np.asarray(rows)
    ok = np.isfinite(row_bw)
    if not ok.any():
        return np.zeros(0)
    bw_med = float(np.median(row_bw[ok]))
    return np.log2(np.where(ok, row_bw, bw_med) / bw_med)


def _row_anchor_parts(c: np.ndarray, med: float,
                      n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node log2 row medians + anchor columns vs the global median —
    the order-sensitive core shared by the dense and tree sketches."""
    off = ~np.eye(n, dtype=bool)
    row_med = np.array([
        np.median(np.maximum(c[i][off[i]], med * 1e-9)) for i in range(n)
    ]) if n > 1 else np.ones(n)
    row_part = np.log2(row_med / med)
    anchors = sorted({0, n // 3, (2 * n) // 3}) if n > 1 else []
    anchor_part = np.concatenate([
        np.log2(np.maximum(np.delete(c[:, a], a), med * 1e-9) / med)
        for a in anchors
    ]) if anchors else np.zeros(0)
    return row_part, anchor_part


def _tree_fingerprint(c: np.ndarray, bw: Optional[np.ndarray],
                      hierarchy) -> FabricFingerprint:
    """Sketch a hierarchy-completed cost matrix plus its tree structure.

    A sparse probe's matrix is already cluster-median-flattened, so its
    per-node row medians and anchor columns barely move across
    re-probes *of the same probe structure* — the same landmark/refine
    pair set, which is what deterministic probe configs and the
    :func:`repro_torch.fabric.refresh_sparse` drift path re-measure (the
    per-pair noise the dense sketch has to tolerate was medianed away
    at completion time).  A re-randomized landmark set is a different
    probe structure and is not promised to match.  The
    tree contributes structure terms (block count + cut height per
    tier, half-octave weighted so one block splitting/merging under
    noise stays inside the match tolerance while a tier
    appearing/halving does not).  No global percentile profile is
    needed — the structure terms carry the distribution's shape — and
    its absence keeps the tree sketch's length distinct from the dense
    sketch's (2·tiers is even, the dense profile is 5 terms), so the
    two probing modes are separate cache namespaces by construction.
    """
    n = c.shape[0]
    off = ~np.eye(n, dtype=bool)
    vals = c[off]
    pos = vals[vals > 0]
    med = float(np.median(pos)) if pos.size else 1.0
    row_part, anchor_part = _row_anchor_parts(c, med, n)
    struct = []
    for tier, h in zip(hierarchy.tiers, hierarchy.heights):
        struct.append(0.5 * np.log2(max(len(tier), 1)))
        struct.append(0.5 * np.log2(max(h, med * 1e-30) / med))
    sketch = tuple(float(x) for x in np.concatenate(
        [row_part, anchor_part, np.asarray(struct), _bw_part(bw, n)]))
    coarse = tuple(int(x) for x in np.round(np.asarray(sketch) / 1.0))
    digest = hashlib.sha256(repr((n,) + coarse).encode()).hexdigest()[:16]
    return FabricFingerprint(n=n, sketch=sketch, digest=f"hfab{n}-{digest}")


def fabric_fingerprint(cost_matrix: np.ndarray,
                       bw: Optional[np.ndarray] = None,
                       hierarchy=None) -> FabricFingerprint:
    """Sketch the probed cost matrix (see module docstring).

    ``bw``, when probed, contributes per-node log2 row medians of the
    bandwidth matrix so a fabric whose bandwidth collapses with
    latencies unchanged does NOT fuzzily match its old plans (the
    compiler's cost models are bw-aware, so those plans are stale).

    ``hierarchy`` — a non-flat recovered
    :class:`repro_torch.fabric.HierarchyModel` over the same nodes — switches
    to the tree sketch (:func:`_tree_fingerprint`): cheaper components
    (block medians, not n row medians + a percentile profile) that are
    markedly more drift-robust under probe noise.
    """
    c = np.asarray(cost_matrix, dtype=np.float64)
    assert c.ndim == 2 and c.shape[0] == c.shape[1], c.shape
    n = c.shape[0]
    if hierarchy is not None and not getattr(hierarchy, "flat", True) \
            and getattr(hierarchy, "n", -1) == n:
        return _tree_fingerprint(c, bw, hierarchy)
    off = ~np.eye(n, dtype=bool)
    vals = c[off]
    pos = vals[vals > 0]
    med = float(np.median(pos)) if pos.size else 1.0
    # per-node row medians + anchor columns (every node's cost to a few
    # fixed reference nodes — row medians alone are permutation-blind
    # when nodes are statistically alike; who-is-near-whom is not)
    row_part, anchor_part = _row_anchor_parts(c, med, n)
    profile = np.log2(np.maximum(np.percentile(pos, _PCTS) / med, 1e-9)) \
        if pos.size else np.zeros(len(_PCTS))
    bw_part = _bw_part(bw, n)
    sketch = tuple(float(x) for x in
                   np.concatenate([row_part, anchor_part, profile, bw_part]))
    coarse = tuple(int(x) for x in np.round(np.asarray(sketch) / 1.0))
    digest = hashlib.sha256(repr((n,) + coarse).encode()).hexdigest()[:16]
    return FabricFingerprint(n=n, sketch=sketch, digest=f"fab{n}-{digest}")


def _request_tag(request_key: str) -> str:
    return hashlib.sha256(request_key.encode()).hexdigest()[:12]


def _sketch_tag(fingerprint: FabricFingerprint) -> str:
    """Exact-sketch hash: uniquifies cache slots so two fabrics whose
    coarse digests collide (sketches round alike but differ by > tol)
    cannot overwrite each other's plans.  Lookups never use it — they
    match sketches fuzzily — so its boundary-sensitivity is harmless."""
    return hashlib.sha256(
        np.asarray(fingerprint.sketch, dtype=np.float64).tobytes()
    ).hexdigest()[:10]


class PlanCache:
    """Thread-safe LRU + optional persistent JSON store of compiled plans.

    Keys are (fabric fingerprint, request key); fingerprint comparison is
    fuzzy (sketch distance), the request key (job-mix key + mesh shape)
    is exact.
    """

    def __init__(self, capacity: int = 32, store_dir: Optional[str] = None,
                 tol: float = DEFAULT_TOL):
        self.capacity = int(capacity)
        self.store_dir = store_dir
        self.tol = float(tol)
        self._lock = threading.RLock()
        #: insertion-ordered: (digest, request_key) -> Plan
        self._mem: "OrderedDict[Tuple[str, str], Plan]" = OrderedDict()
        self.stats = {"hits": 0, "disk_hits": 0, "misses": 0,
                      "puts": 0, "invalidations": 0}
        if store_dir:
            os.makedirs(store_dir, exist_ok=True)

    # -- core API ---------------------------------------------------------
    def get(self, fingerprint: FabricFingerprint,
            request_key: str = "") -> Optional[Plan]:
        with self._lock:
            for key, plan in reversed(self._mem.items()):
                if key[-1] == request_key and \
                        fingerprint.matches(plan.fingerprint, self.tol):
                    self._mem.move_to_end(key)
                    self.stats["hits"] += 1
                    obs.metrics().counter("plan.cache.hits").inc()
                    return plan
            plan = self._load_from_store(fingerprint, request_key)
            if plan is not None:
                self._insert(plan, request_key)
                self.stats["disk_hits"] += 1
                obs.metrics().counter("plan.cache.disk_hits").inc()
                return plan
            self.stats["misses"] += 1
            obs.metrics().counter("plan.cache.misses").inc()
            return None

    def peek_mem(self, fingerprint: FabricFingerprint,
                 request_key: str = "") -> Optional[Plan]:
        """Memory-only probe: no disk scan, no stats, no LRU touch.

        For callers (the planning service) that must re-check under
        their own lock without serializing everyone behind store I/O.
        """
        with self._lock:
            for key, plan in reversed(self._mem.items()):
                if key[-1] == request_key and \
                        fingerprint.matches(plan.fingerprint, self.tol):
                    return plan
            return None

    def put(self, plan: Plan, request_key: str = "") -> None:
        with self._lock:
            self._insert(plan, request_key)
            self.stats["puts"] += 1
            obs.metrics().counter("plan.cache.puts").inc()
            if self.store_dir:
                path = self._path(plan.fingerprint, request_key)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(plan.to_json())
                os.replace(tmp, path)

    def invalidate(self, fingerprint: FabricFingerprint,
                   request_key: Optional[str] = None) -> int:
        """Drop every plan whose fingerprint fuzzily matches.

        ``request_key=None`` (drift semantics: the *fabric* changed)
        drops all mixes compiled against the fabric; a specific key
        drops just that plan.  Returns the number of entries dropped.
        """
        dropped = 0
        with self._lock:
            for key in list(self._mem):
                plan = self._mem[key]
                if request_key is not None and key[-1] != request_key:
                    continue
                if fingerprint.matches(plan.fingerprint, self.tol):
                    del self._mem[key]
                    dropped += 1
            if self.store_dir:
                tag = None if request_key is None else _request_tag(request_key)
                for fname, plan_fp, _rk in self._store_index():
                    if tag is not None and not fname.endswith(f"__{tag}.json"):
                        continue
                    if plan_fp is not None and fingerprint.matches(plan_fp, self.tol):
                        try:
                            os.remove(os.path.join(self.store_dir, fname))
                            dropped += 1
                        except OSError:
                            pass
            self.stats["invalidations"] += dropped
            if dropped:
                obs.metrics().counter("plan.cache.invalidations").inc(dropped)
        return dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    # -- internals --------------------------------------------------------
    def _insert(self, plan: Plan, request_key: str) -> None:
        key = (plan.fingerprint.digest, _sketch_tag(plan.fingerprint),
               request_key)
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)

    def _path(self, fingerprint: FabricFingerprint, request_key: str) -> str:
        assert self.store_dir
        return os.path.join(
            self.store_dir,
            f"{fingerprint.digest}-{_sketch_tag(fingerprint)}"
            f"__{_request_tag(request_key)}.json")

    def _quarantine(self, fname: str, error: Exception) -> None:
        """Rename an unreadable store file to ``*.corrupt`` (skipped by
        every future scan) instead of re-parsing — and re-failing — it
        on every lookup.  A truncated write (a crashed process, a full
        disk) must cost one warning, not poison ``get()`` forever."""
        path = os.path.join(self.store_dir, fname)
        try:
            os.replace(path, path + ".corrupt")
            note = f"quarantined as {fname}.corrupt"
        except OSError as rename_err:
            note = f"quarantine rename failed: {rename_err}"
        obs.tracer().event("plan.cache.quarantine", file=fname,
                           error=f"{type(error).__name__}: {error}")
        obs.metrics().counter("plan.cache.quarantines").inc()
        # stacklevel walks _quarantine -> _store_index/_load_from_store
        # -> get/invalidate -> the caller outside the cache (4 frames):
        # the warning should point at whoever asked for the plan, not at
        # cache internals
        warnings.warn(
            f"plan cache store file {fname} is corrupted "
            f"({type(error).__name__}: {error}); {note}",
            RuntimeWarning, stacklevel=4)

    def _store_index(self) -> List[Tuple[str, Optional[FabricFingerprint],
                                         Optional[str]]]:
        if not self.store_dir or not os.path.isdir(self.store_dir):
            return []
        out = []
        for fname in sorted(os.listdir(self.store_dir)):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.store_dir, fname)) as f:
                    d = json.load(f)
                fp = FabricFingerprint.from_dict(d["fingerprint"])
                rk = str(d.get("mix_key", ""))
                out.append((fname, fp, rk))
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._quarantine(fname, e)
        return out

    def _load_from_store(self, fingerprint: FabricFingerprint,
                         request_key: str) -> Optional[Plan]:
        if not self.store_dir:
            return None
        tag = _request_tag(request_key)
        for fname in sorted(os.listdir(self.store_dir)):
            if not fname.endswith(f"__{tag}.json"):
                continue
            try:
                with open(os.path.join(self.store_dir, fname)) as f:
                    plan = Plan.from_json(f.read())
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._quarantine(fname, e)
                continue
            if fingerprint.matches(plan.fingerprint, self.tol):
                return plan
        return None


@dataclasses.dataclass
class DriftReport:
    stale: bool
    degraded: List[EntryKey]
    repaired: Dict[EntryKey, Tuple[int, ...]]
    invalidated: int = 0


class DriftMonitor:
    """Per-entry :class:`AdaptiveReranker`s that invalidate a cached plan.

    ``reference_cost_matrix`` is the matrix the plan was compiled
    against (it seeds each reranker's reference cost); ``observe`` feeds
    refreshed matrices.  When any entry degrades past ``threshold`` x
    its reference, the entry is hot-patched with the reranker's
    bottleneck-swap repair and the plan is evicted from ``cache``.
    """

    def __init__(self, plan: Plan, reference_cost_matrix: np.ndarray,
                 cache: Optional[PlanCache] = None, threshold: float = 1.15):
        self.plan = plan
        self.cache = cache
        self.threshold = float(threshold)
        self._rerankers: Dict[EntryKey, AdaptiveReranker] = {}
        ref = np.asarray(reference_cost_matrix, dtype=np.float64)
        for key, entry in plan.entries.items():
            factory = self._factory(entry)
            rr = AdaptiveReranker(
                model_factory=factory,
                perm=entry.local_perm.copy(),
                threshold=self.threshold,
            )
            rr.update(self._sub(ref, entry))       # seeds reference_cost
            self._rerankers[key] = rr

    def set_threshold(self, threshold: float) -> None:
        """Adjust drift sensitivity on the live monitor (all rerankers)."""
        self.threshold = float(threshold)
        for rr in self._rerankers.values():
            rr.threshold = float(threshold)

    @staticmethod
    def _sub(c: np.ndarray, entry: PlanEntry) -> np.ndarray:
        g = np.asarray(entry.group, dtype=np.int64)
        return c[np.ix_(g, g)]

    @staticmethod
    def _factory(entry: PlanEntry):
        m_algo = get_builder(entry.algo).cost_model
        kwargs = {"base": entry.algo_kwargs["base"]} \
            if "base" in entry.algo_kwargs else {}

        def make(c: np.ndarray):
            return make_cost_model(m_algo, cost_matrix=c, size_bytes=0.0,
                                   **kwargs)

        return make

    def observe(self, cost_matrix: np.ndarray) -> DriftReport:
        """Feed a refreshed full-fabric cost matrix; see class docstring.

        Rejects malformed observations with :class:`ValueError` — a NaN
        from a corrupted probe sample fed into the rerankers would
        silently poison every solver delta downstream.
        """
        c = np.asarray(cost_matrix, dtype=np.float64)
        if c.ndim != 2 or c.shape[0] != c.shape[1]:
            raise ValueError(
                f"DriftMonitor.observe cost_matrix must be a square "
                f"[n, n] matrix; got shape {c.shape}")
        if c.shape[0] != self.plan.n:
            raise ValueError(
                f"DriftMonitor.observe cost_matrix covers {c.shape[0]} "
                f"nodes but the plan covers {self.plan.n}; after an "
                f"elastic membership change, rebuild the monitor from "
                f"the recovered plan")
        if np.isnan(c).any():
            bad = int(np.isnan(c).sum())
            raise ValueError(
                f"DriftMonitor.observe cost_matrix contains {bad} NaN "
                f"entr{'y' if bad == 1 else 'ies'}; drop or re-probe the "
                f"corrupted samples before observing")
        if (c < 0).any():
            i, j = np.argwhere(c < 0)[0]
            raise ValueError(
                f"DriftMonitor.observe cost_matrix contains negative "
                f"entries (first at [{i}, {j}] = {c[i, j]}); costs are "
                f"times and must be >= 0")
        degraded: List[EntryKey] = []
        repaired: Dict[EntryKey, Tuple[int, ...]] = {}
        for key, rr in self._rerankers.items():
            entry = self.plan.entries[key]
            new_local, changed = rr.update(self._sub(c, entry))
            if changed:
                degraded.append(key)
                g = np.asarray(entry.group, dtype=np.int64)
                new_perm = tuple(int(x) for x in g[np.asarray(new_local)])
                repaired[key] = new_perm
                entry.perm = new_perm              # hot patch until recompile
        stale = bool(degraded)
        invalidated = 0
        if stale:
            self.plan.meta["stale"] = True
            if self.cache is not None:
                invalidated = self.cache.invalidate(self.plan.fingerprint)
        m = obs.metrics()
        m.counter("drift.observations").inc()
        m.gauge("drift.degraded_entries").set(len(degraded))
        # drift score: fraction of plan entries past their reranker
        # threshold this observation — 0.0 on a quiet fabric
        m.gauge("drift.score").set(
            len(degraded) / max(len(self.plan.entries), 1))
        if stale:
            m.counter("drift.stale").inc()
            obs.tracer().event("drift.stale", degraded=len(degraded),
                               invalidated=invalidated)
        return DriftReport(stale=stale, degraded=degraded,
                           repaired=repaired, invalidated=invalidated)
