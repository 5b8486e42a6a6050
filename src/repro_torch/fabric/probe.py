"""Pairwise distance probing (paper §IV-B), a copy of ``repro.fabric.probe``.

:func:`probe_fabric` probes offline: it draws per-probe RTT samples from
a :class:`~repro_torch.fabric.topology.Fabric` plus multi-tenant noise and
applies the paper's pipeline (k probes per directed pair, take the 10th
percentile to filter interference, symmetrize with MAX).  It returns a
``ProbeResult`` with the measured latency matrix (seconds) and optional
bandwidth matrix, from which :func:`cost_matrix` builds c_{i,j}(S).

The reference's live-device probe (``probe_mesh_pairwise``, timed
transfers between devices) is not ported yet: on the card it becomes
timed copies between CUDA devices (ROADMAP.md §1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs

from .costs import combine_cost
from .topology import Fabric

__all__ = ["ProbeResult", "probe_fabric", "cost_matrix"]


@dataclasses.dataclass
class ProbeResult:
    lat: np.ndarray                 # [n, n] seconds, symmetrized (MAX)
    bw: Optional[np.ndarray] = None  # [n, n] bytes/s or None (latency-only)
    n_probes: int = 0
    percentile: float = 10.0

    @property
    def n(self) -> int:
        return self.lat.shape[0]

    def subset(self, nodes: Sequence[int]) -> "ProbeResult":
        """Measurements restricted to ``nodes`` (elastic membership).

        Mirrors :meth:`Fabric.subset`: ``nodes[k]`` becomes local id
        ``k``, and the same validation applies — a wrong survivor list
        fails loudly here, not as an index error inside a solver.
        """
        idx = _validate_subset(nodes, self.n, type(self).__name__)
        return ProbeResult(
            lat=self.lat[np.ix_(idx, idx)].copy(),
            bw=None if self.bw is None
            else self.bw[np.ix_(idx, idx)].copy(),
            n_probes=self.n_probes, percentile=self.percentile)


def _validate_subset(nodes: Sequence[int], n: int, owner: str) -> np.ndarray:
    nodes = [int(x) for x in nodes]
    if not nodes:
        raise ValueError(
            f"{owner}.subset needs at least one node; got an empty list")
    bad = [x for x in nodes if x < 0 or x >= n]
    if bad:
        raise ValueError(
            f"{owner}.subset node ids {bad} out of range for {n} nodes "
            f"(valid ids: 0..{n - 1})")
    if len(set(nodes)) != len(nodes):
        dups = sorted({x for x in nodes if nodes.count(x) > 1})
        raise ValueError(
            f"{owner}.subset node ids must be unique; duplicates: {dups}")
    return np.asarray(nodes, dtype=np.int64)


def probe_fabric(
    fabric: Fabric,
    n_probes: int = 1000,
    percentile: float = 10.0,
    noise_scale: float = 0.3,
    seed: int = 0,
    measure_bw: bool = True,
) -> ProbeResult:
    """Simulated probing with the paper's filtering pipeline.

    Each directed pair receives ``n_probes`` probes; each probe observes
    ``rtt = 2 * lat * (1 + Exp(noise))`` (queueing is one-sided heavy
    noise, hence exponential).  We keep the ``percentile``-th percentile
    — the paper's anti-interference filter — halve it back to one-way
    cost, then symmetrize with MAX (paper: c_ij <- MAX(c_ij, c_ji)).

    Vectorized: the percentile of ``lat * (1 + noise)`` equals
    ``lat * (1 + pct(noise))`` for per-pair iid noise, so we draw one
    noise block of shape [n_probes] per pair batch instead of n^2 loops.

    Raises :class:`ValueError` for nonsensical parameters — a percentile
    outside (0, 100] or a negative noise scale would silently produce
    garbage matrices that only fail much later, inside the solver.
    """
    _validate_probe_params(n_probes, percentile, noise_scale)
    timer = obs.tracer().timer("fabric.probe.dense", n=fabric.n)
    with timer:
        rng = np.random.default_rng(seed)
        n = fabric.n
        # Draw per-pair percentile noise factors (each directed pair gets
        # its own probe population — simulated via per-pair percentile
        # draws).
        noise = rng.exponential(noise_scale, size=(n, n, 16))
        pct = np.percentile(noise, percentile, axis=-1)
        lat = fabric.lat * (1.0 + pct)
        np.fill_diagonal(lat, 0.0)
        lat = np.maximum(lat, lat.T)
        bw = None
        if measure_bw:
            # Bandwidth estimate from a burst probe (degraded by load).
            load = np.clip(rng.normal(0.0, 0.05, size=(n, n)), -0.15, 0.3)
            bw = fabric.bw * (1.0 - load)
            bw = np.minimum(bw, bw.T)
            np.fill_diagonal(bw, np.inf)
    m = obs.metrics()
    m.counter("fabric.probe.sweeps").inc()
    m.histogram("fabric.probe.seconds", scale=1e-3).observe(timer.elapsed)
    return ProbeResult(lat=lat, bw=bw, n_probes=n_probes, percentile=percentile)


def _validate_probe_params(n_probes: int, percentile: float,
                           noise_scale: float) -> None:
    """Shared probe-parameter validation (dense and sparse probing)."""
    if n_probes < 1:
        raise ValueError(
            f"n_probes must be >= 1 (each directed pair needs at least one "
            f"probe); got {n_probes}")
    if not 0.0 < percentile <= 100.0:
        raise ValueError(
            f"percentile must be in (0, 100] (the paper keeps the 10th "
            f"percentile as its anti-interference filter); got {percentile}")
    if noise_scale < 0.0:
        raise ValueError(
            f"noise_scale must be >= 0 (it is the scale of the exponential "
            f"queueing-noise distribution); got {noise_scale}")


def cost_matrix(probe: ProbeResult, size_bytes: float = 0.0) -> np.ndarray:
    """c_{i,j}(S) = lat + S/bw (S=0 recovers the paper's latency-only c).

    Raises :class:`ValueError` when the probe is empty or malformed —
    an unprobed fabric must fail here with a usable message, not as a
    numpy shape error inside the solver.
    """
    lat = np.asarray(probe.lat)
    if lat.size == 0:
        raise ValueError(
            "cost_matrix got an empty ProbeResult (0 nodes); probe the "
            "fabric first (probe_fabric) or attach "
            "a non-empty fabric")
    if lat.ndim != 2 or lat.shape[0] != lat.shape[1]:
        raise ValueError(
            f"cost_matrix needs a square [n, n] latency matrix; got shape "
            f"{lat.shape}")
    return combine_cost(lat, probe.bw, size_bytes)
