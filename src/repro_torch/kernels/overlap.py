"""Compute–communication overlap for certified collective schedules.

Counterpart of ``repro.kernels.overlap``.
:mod:`~repro_torch.kernels.schedule_runner` runs a certified
:class:`~repro_torch.collective.executors.LoweredSchedule` on its own;
this module fuses one into a surrounding step as a round-pipelined state
machine:

* **issue** — gather each step's payload from round-entry state and
  "send" it (an index gather over the virtual mesh's rank dimension);
* **apply** — land the staged receives at the round barrier (``reduce``
  accumulates through
  :func:`~repro_torch.kernels.ring_collective.fused_add`, ``copy``
  overwrites);
* **overlap** — between issue and apply, run resident compute shards and
  the *next* transfer.  The ``chunk_factor`` pieces of one round are
  column-disjoint slices of the chunk buffers, so piece ``p + 1``'s
  transfer is issued before piece ``p``'s reduce lands.

An :class:`OverlapPlan` lists, per ``(round, piece)`` slot, which
caller-supplied compute shards run while that slot's transfer is in
flight.  In the reference the order in which that work executes is
XLA's business; here everything is issued in plan order on PyTorch's
current CUDA stream, so the plan fixes the order of work on one stream
(a communication stream beside a compute stream is later work,
ROADMAP.md §1).

Certification boundary: schedules are certified before fusion, and
fusion never edits a round — partial execution goes through
:meth:`LoweredSchedule.slice_rounds`.  :func:`run_overlapped` therefore
computes element for element what
:func:`~repro_torch.kernels.schedule_runner.run_schedule` computes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.collective.executors import LoweredSchedule

from .schedule_runner import (
    apply_round,
    device_tables,
    finish_state,
    issue_round,
    piece_slices,
    seed_state,
)

__all__ = [
    "OverlapSlot",
    "OverlapPlan",
    "build_overlap_plan",
    "run_overlapped",
    "seed_state",
    "finish_state",
]


@dataclasses.dataclass(frozen=True)
class OverlapSlot:
    """One pipeline slot: a ``(round, piece)`` transfer + resident compute.

    ``round_index`` indexes the (possibly sliced) schedule's rounds; a
    negative value marks a drain slot that only runs compute.
    ``compute`` holds indices into the caller's compute-shard list —
    those shards run while this slot's transfer is in flight.
    """

    round_index: int
    piece: int
    compute: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Explicit interleaving of schedule rounds with compute shards.

    Slots are executed in order; every ``(round, piece)`` of the
    schedule appears exactly once, rounds grouped and ascending (round
    barriers are data dependencies — pieces of one round commute, rounds
    do not).  The plan never rewrites the schedule: it only decides
    *when*, relative to the certified rounds, each compute shard runs.
    """

    schedule: LoweredSchedule
    n_compute: int
    slots: Tuple[OverlapSlot, ...]

    def validate(self) -> None:
        k = max(1, self.schedule.chunk_factor)
        want = [(r, p) for r in range(len(self.schedule.rounds))
                for p in range(k)]
        got = [(s.round_index, s.piece) for s in self.slots
               if s.round_index >= 0]
        if sorted(got) != want:
            raise ValueError(
                f"plan must cover every (round, piece) exactly once: "
                f"want {len(want)} slots, got {sorted(got)!r}")
        rounds_seen = [r for r, _ in got]
        if rounds_seen != sorted(rounds_seen):
            raise ValueError("slots must keep rounds in ascending order")
        cids = [c for s in self.slots for c in s.compute]
        if len(set(cids)) != len(cids) or any(
                not (0 <= c < self.n_compute) for c in cids):
            raise ValueError(
                f"compute ids must each appear once and lie in "
                f"[0, {self.n_compute}): got {cids!r}")


def build_overlap_plan(schedule: LoweredSchedule,
                       n_compute: int = 0) -> OverlapPlan:
    """Default plan: compute shards spread evenly over the slot grid.

    Slots run round-major (pieces of a round adjacent, so the
    double-buffered issue of piece ``p + 1`` overlaps piece ``p``'s
    apply).  Leftover compute — or all of it, for a round-less
    schedule — lands in a trailing drain slot.
    """
    k = max(1, schedule.chunk_factor)
    grid = [(r, p) for r in range(len(schedule.rounds)) for p in range(k)]
    if not grid:
        slots = ((OverlapSlot(-1, 0, tuple(range(n_compute))),)
                 if n_compute else ())
        return OverlapPlan(schedule, n_compute, slots)
    splits = np.array_split(np.arange(n_compute), len(grid))
    slots = tuple(
        OverlapSlot(r, p, tuple(int(c) for c in cids))
        for (r, p), cids in zip(grid, splits))
    return OverlapPlan(schedule, n_compute, slots)


def run_overlapped(
    x,
    plan: Union[OverlapPlan, LoweredSchedule],
    compute: Sequence[Callable[[], Any]] = (),
    *,
    use_kernel_add: bool = True,
    state: Optional[torch.Tensor] = None,
    rounds: Optional[Tuple[int, Optional[int]]] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, List[Any]]:
    """Execute ``plan`` with compute shards fused into the round pipeline.

    ``plan`` is an :class:`OverlapPlan` or a bare certified
    :class:`LoweredSchedule` (a default plan is built over it).  With a
    bare schedule, ``rounds=(start, stop)`` executes only that window
    (via :meth:`LoweredSchedule.slice_rounds`); pass ``state`` to resume
    mid-stream (it is updated in place) and ``return_state=True`` to keep
    pipelining later.

    Returns ``(out, results)``: ``out`` equals
    :func:`~repro_torch.kernels.schedule_runner.run_schedule`'s output
    bit for bit (or is the raw position-major state when
    ``return_state``), and ``results[i]`` is compute shard ``i``'s value.
    """
    if isinstance(plan, LoweredSchedule):
        schedule = plan if rounds is None else plan.slice_rounds(*rounds)
        plan = build_overlap_plan(schedule, len(compute))
    else:
        if rounds is not None:
            raise ValueError("pass rounds= only with a bare schedule; "
                             "an OverlapPlan already fixes its window")
        schedule = plan.schedule
        if plan.n_compute != len(compute):
            raise ValueError(f"plan expects {plan.n_compute} compute "
                             f"shards, got {len(compute)}")
    plan.validate()

    if state is None:
        state = seed_state(schedule, x)
    n_chunks = schedule.n_chunks
    if state.dim() != 3 or state.shape[:2] != (schedule.n, n_chunks + 1):
        raise ValueError(f"state must be [n={schedule.n}, n_chunks+1="
                         f"{n_chunks + 1}, chunk_len], got {tuple(state.shape)}")
    cols = piece_slices(state.shape[-1], max(1, schedule.chunk_factor))
    steps = device_tables(schedule, state.device)

    def issue(slot: OverlapSlot) -> Optional[List[torch.Tensor]]:
        if slot.round_index < 0:
            return None
        return issue_round(state, steps[slot.round_index], cols[slot.piece])

    results: List[Any] = [None] * len(compute)
    slots = plan.slots
    staged_next = issue(slots[0]) if slots else None
    for i, slot in enumerate(slots):
        staged, staged_next = staged_next, None
        nxt = slots[i + 1] if i + 1 < len(slots) else None
        same_round = nxt is not None and nxt.round_index == slot.round_index
        # double buffer: the next piece of this round reads the same
        # round-entry columns, so its transfer is staged before this
        # slot's reduce lands
        if same_round:
            staged_next = issue(nxt)
        for cid in slot.compute:
            results[cid] = compute[cid]()
        if staged is not None:
            apply_round(state, steps[slot.round_index], staged,
                        cols[slot.piece], n_chunks, use_kernel_add)
        if nxt is not None and not same_round:
            staged_next = issue(nxt)

    if return_state:
        return state, results
    return finish_state(schedule, state), results
