"""Fabric fingerprints: the key a compiled plan is stored and matched under.

A copy of the fingerprint half of ``repro.plan.cache``.  A plan's rank
permutations refer to concrete node ids, so the fingerprint must be
*order-sensitive* (a re-scrambled IP list must not hit a stale plan) yet
*noise-robust* (re-probing the same fabric must hit the cache).  Exact
hashing of quantized costs is boundary-brittle — with n^2 elements some
always sit on a bin edge — so :func:`fabric_fingerprint` builds a
**sketch**: per-node log2 row medians (order-sensitive, median-of-n is
stable under per-pair probe noise) plus the global log2 percentile
profile (shape of the cost distribution).  Lookups match sketches
fuzzily (:meth:`FabricFingerprint.matches`, max component distance below
``tol`` octaves); the exact ``digest`` — a coarse hash — is only an id
for filenames and logs.

The reference's ``PlanCache`` and ``DriftMonitor`` (the LRU and JSON
store, drift-driven invalidation) are not ported yet (ROADMAP.md §1
slice 4b); :class:`~repro_torch.plan.compiler.PlanCompiler` needs only
the fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["FabricFingerprint", "fabric_fingerprint", "DEFAULT_TOL"]

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
    ``refresh_sparse`` (the sparse probe of the reference; not ported yet) drift path re-measure (the
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
