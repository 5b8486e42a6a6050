"""The one pairwise-cost formula every fabric artifact shares.

The paper's cost is c_{i,j}(S) = latency + S / bandwidth, symmetrized
with MAX (§IV-B).  Before ``repro_torch.fabric`` existed that formula lived
twice — :meth:`Fabric.cost_matrix` and :func:`repro_torch.fabric.probe.cost_matrix`
each re-implemented it — and the copies had already drifted in how they
handled a missing bandwidth matrix.  Both now call :func:`combine_cost`;
their public signatures are unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["combine_cost"]


def combine_cost(lat: np.ndarray, bw: Optional[np.ndarray] = None,
                 size_bytes: float = 0.0) -> np.ndarray:
    """c_{i,j}(S) = lat + S/bw, zero diagonal, symmetrized with MAX.

    ``size_bytes=0`` (or ``bw=None``) recovers the paper's latency-only
    cost; TPU callers pass the real payload so multi-MB transfers are
    bandwidth-dominated.  Always returns a fresh array.
    """
    lat = np.asarray(lat, dtype=np.float64)
    if lat.ndim != 2 or lat.shape[0] != lat.shape[1]:
        raise ValueError(
            f"combine_cost needs a square [n, n] latency matrix; got shape "
            f"{lat.shape}")
    c = lat.copy()
    if size_bytes and bw is not None:
        with np.errstate(divide="ignore"):
            c = c + float(size_bytes) / np.asarray(bw, dtype=np.float64)
    np.fill_diagonal(c, 0.0)
    return np.maximum(c, c.T)
