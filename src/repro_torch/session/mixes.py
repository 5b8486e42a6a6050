"""Canonical workload job mixes (a copy of ``repro.session.mixes``).

One place declares the collective histograms the planner compiles for:
the training step's and the decode path's.
"""

from __future__ import annotations

from repro_torch.plan import CollectiveRequest, JobMix

__all__ = ["train_mix", "serve_mix", "default_mix"]


def train_mix(payload_bytes: float, moe: bool = False) -> JobMix:
    """A training step's collective histogram at ``payload_bytes``
    gradients: the per-step DP reduction plus the per-layer TP pair, and
    the EP all-to-all when the arch routes experts."""
    reqs = [
        CollectiveRequest("all-reduce", payload_bytes),           # gradients
        CollectiveRequest("all-gather", payload_bytes / 8, count=2.0),
        CollectiveRequest("reduce-scatter", payload_bytes / 8, count=2.0),
    ]
    if moe:
        reqs.append(CollectiveRequest("all-to-all", payload_bytes / 16,
                                      count=2.0))
    return JobMix(requests=tuple(reqs), name="train")


def serve_mix(payload_bytes: float, moe: bool = False) -> JobMix:
    """The decode path's collective histogram: per-layer TP all-gather /
    reduce-scatter dominate; a small all-reduce syncs sampling state; MoE
    archs add the EP all-to-all.  (No gradient all-reduce — that is the
    training mix.)"""
    reqs = [
        CollectiveRequest("all-gather", payload_bytes, count=2.0),
        CollectiveRequest("reduce-scatter", payload_bytes, count=2.0),
        CollectiveRequest("all-reduce", max(payload_bytes / 64, 1.0)),
    ]
    if moe:
        reqs.append(CollectiveRequest("all-to-all", payload_bytes, count=2.0))
    return JobMix(requests=tuple(reqs), name="serve")


def default_mix(workload: str, payload_bytes: float, moe: bool = False) -> JobMix:
    """Mix for a session workload name (``"train"`` or ``"serve"``)."""
    if workload == "serve":
        return serve_mix(payload_bytes, moe=moe)
    if workload == "train":
        return train_mix(payload_bytes, moe=moe)
    raise ValueError(f"unknown workload {workload!r}; "
                     f"expected 'train' or 'serve'")
