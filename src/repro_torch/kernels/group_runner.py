"""Execute a certified :class:`LoweredSchedule` over a process group.

Counterpart of the reference's ``shard_map`` runners (``_make_issue`` /
``_make_apply`` in ``repro.kernels.overlap`` and ``run_schedule`` over a
mesh in ``repro.kernels.schedule_runner``), where the device at axis
index ``i`` of a planned mesh holds position ``i``'s row and a permute
step is a ``ppermute`` between devices.  Here the mesh is a group-backed
:class:`~repro_torch.launch.PlannedMesh`
(:func:`~repro_torch.launch.make_planned_mesh` with a ``group``), every
process holds one row, and a step is point-to-point send/recv:

* **layout** — the mesh decides it: schedule position ``i`` is mesh slot
  ``i``, which lives in the process at group rank ``mesh.order[i]`` (so
  with the identity order, group rank ``i`` is position ``i``).  A
  process holds one ``[n_chunks + 1, chunk_len]`` row, seeded from
  logical rank ``schedule.rank_of[mesh.slot]``'s input as
  :func:`~repro_torch.kernels.schedule_runner.seed_state` seeds that
  position (:func:`local_rank` names the input a process passes);
* **one round** — a link ``(s, d)`` fires iff ``send_mask[s] and
  recv_mask[d]`` (the port's own
  :func:`~repro_torch.kernels.schedule_runner.schedule_tables`); every
  payload is the sender's rows ``send[s]`` of the *round-entry* row,
  restricted to the piece's columns; all of the round's sends and
  receives are posted in one :func:`torch.distributed.batch_isend_irecv`
  and waited on; then the steps land in order: ``reduce`` through
  :func:`~repro_torch.kernels.ring_collective.accumulate` (the
  ``fused_add`` kernel on the card, its plain version on the CPU),
  ``copy`` overwrites, and the scratch row is zeroed after every step;
* ``chunk_factor`` pieces run one after the other, as
  :func:`~repro_torch.kernels.schedule_runner.piece_slices` gives them.

So every position's final row equals the virtual-mesh runner's row for
that position bit for bit, wherever the mesh places it: the same adds in
the same order.

Certified schedules only: :func:`run_schedule_group` takes the
:class:`~repro_torch.collective.Lowered` that
:meth:`repro_torch.session.Session.lower` (or
:meth:`~repro_torch.collective.ScheduleLowering.lower`) built, which
carries its program, or a ``(program, schedule)`` pair; either way it
certifies the schedule against the program
(:func:`repro_torch.analysis.require_certified`) before any exchange.  A
bare :class:`LoweredSchedule`, or a ``Lowered`` without its program,
raises.

Transport: the group's backend is gloo (NCCL builds no multi-rank
communicator on one GPU).  A row on the card stages each payload through
pinned host memory: device to host, then send; receive into host, then
host to device, where the reduce runs.  Any other backend raises, and so
does an input on another device type than the mesh's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.collective.executors import Lowered, LoweredSchedule
from repro_torch.launch.mesh import PlannedMesh

from .ring_collective import accumulate
from .schedule_runner import fill_row, piece_slices, row_shape, schedule_tables

__all__ = ["gather_rows", "local_rank", "reduce_count", "run_schedule_group"]


def _certified_schedule(artifact: Any) -> LoweredSchedule:
    """The schedule of ``artifact``, certified here; raises on anything
    else.

    ``artifact`` is a :class:`Lowered` that carries its program (as
    :meth:`~repro_torch.collective.ScheduleLowering.lower` builds it) or
    a ``(program, schedule)`` pair.
    """
    from repro_torch.analysis import require_certified

    if isinstance(artifact, LoweredSchedule):
        raise TypeError(
            "run_schedule_group takes a certified artifact: a Lowered from "
            "Session.lower or a (program, schedule) pair, not a bare "
            "LoweredSchedule")
    if isinstance(artifact, Lowered):
        if artifact.program is None or artifact.schedule is None:
            raise ValueError("the Lowered carries no program and schedule "
                             "to certify; build it with ScheduleLowering."
                             "lower or Session.lower")
        program, schedule = artifact.program, artifact.schedule
    elif isinstance(artifact, tuple) and len(artifact) == 2:
        program, schedule = artifact
    else:
        raise TypeError(f"want a Lowered or a (program, schedule) pair, got "
                        f"{type(artifact).__name__}")
    require_certified(program, schedule)
    return schedule


def local_rank(schedule: LoweredSchedule, mesh: PlannedMesh) -> int:
    """The logical rank whose input this process passes: the one its
    position (its mesh slot) holds, ``schedule.rank_of[mesh.slot]``."""
    return schedule.rank_of[mesh.slot]


def reduce_count(schedule: LoweredSchedule, position: int) -> int:
    """Reduces ``position`` makes in one run: one for each live reduce
    step that lands on it, for each ``chunk_factor`` piece (each is one
    ``fused_add`` launch on the card)."""
    tables, ops = schedule_tables(schedule)
    steps = sum(1 for rnd, rnd_ops in zip(tables, ops)
                for (eff, _, _), op in zip(rnd, rnd_ops)
                if op == "reduce" and any(d == position for _, d in eff))
    return steps * max(1, schedule.chunk_factor)


def _check_mesh(schedule: LoweredSchedule, mesh: PlannedMesh) -> None:
    if mesh.group is None:
        raise ValueError("the group runner takes a group-backed mesh: "
                         "make_planned_mesh(plan, device, group=...)")
    backend = dist.get_backend(mesh.group)
    if backend != "gloo":
        raise ValueError(f"the group runner moves payloads over gloo, not "
                         f"{backend!r}")
    if len(mesh.shape) != 1 or mesh.size != schedule.n:
        raise ValueError(f"the schedule has {schedule.n} positions, the "
                         f"mesh shape {mesh.shape}: want one axis of "
                         f"{schedule.n}")
    size = dist.get_world_size(mesh.group)
    if size != schedule.n:
        raise ValueError(f"the group has {size} processes, the schedule "
                         f"{schedule.n} positions")


class _Stager:
    """Host copies of the payloads of a row on the card (pinned), timed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type != "cpu"
        self.seconds = 0.0

    def out(self, t: torch.Tensor) -> torch.Tensor:
        if not self.on_card:
            return t
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)                         # waits for the card
        self.seconds += time.perf_counter() - t0
        return host

    def buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.on_card)

    def into(self, host: torch.Tensor) -> torch.Tensor:
        if not self.on_card:
            return host
        t0 = time.perf_counter()
        t = host.to(self.device)              # a synchronous copy
        self.seconds += time.perf_counter() - t0
        return t


def _index(rows: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(rows.astype(np.int64), device=device)


def run_schedule_group(x: torch.Tensor, artifact: Any, mesh: PlannedMesh, *,
                       stats: Optional[Dict[str, float]] = None
                       ) -> torch.Tensor:
    """Run a certified schedule over ``mesh``'s group; returns this
    process's row.

    ``x`` is logical rank :func:`local_rank`'s input, ``[D]`` (shaped as
    :func:`~repro_torch.kernels.schedule_runner.row_shape` says), on the
    mesh's device type.  Returns this position's final ``[n_chunks,
    chunk_len]`` buffer on ``x``'s device (:func:`gather_rows` puts all
    of them in rank order).  A ``stats`` dict receives ``wall_s`` (the
    run, from the seeded row to the synchronised result, certification
    excluded), ``stage_s`` (its host copies of a row on the card) and
    ``rounds``.
    """
    schedule = _certified_schedule(artifact)
    _check_mesh(schedule, mesh)
    if x.device.type != torch.device(mesh.device).type:
        raise ValueError(f"the input is on {x.device}, the mesh's ranks on "
                         f"{mesh.device}")
    me = mesh.slot
    t_start = time.perf_counter()
    if x.dim() != 1:
        raise ValueError(f"want this process's [D] input, got {tuple(x.shape)}")
    n_chunks = schedule.n_chunks
    row = x.new_empty(row_shape(schedule, x.shape[0]))
    fill_row(row, schedule, schedule.rank_of[me], x)
    stage = _Stager(row.device)
    tables, ops = schedule_tables(schedule)
    # position j lives in the process at group rank mesh.order[j]
    peer = [dist.get_global_rank(mesh.group, g) for g in mesh.order]
    for cols in piece_slices(row.shape[-1], max(1, schedule.chunk_factor)):
        width = cols.stop - cols.start
        for rnd_tables, rnd_ops in zip(tables, ops):
            p2p, landed = [], []
            for tag, ((eff, send, recv), op) in enumerate(zip(rnd_tables,
                                                              rnd_ops)):
                dst = next((d for s, d in eff if s == me), None)
                src = next((s for s, d in eff if d == me), None)
                if dst is None and src is None:
                    continue
                payload = None
                if dst is not None:   # the round-entry rows (a copy)
                    payload = row[_index(send[me], row.device), cols]
                if src == me:         # a link onto itself moves nothing
                    landed.append((op, recv[me], payload))
                    continue
                if dst is not None:
                    p2p.append(dist.P2POp(dist.isend, stage.out(payload),
                                          peer[dst], mesh.group, tag))
                if src is not None:
                    host = stage.buffer((send.shape[1], width), row.dtype)
                    p2p.append(dist.P2POp(dist.irecv, host, peer[src],
                                          mesh.group, tag))
                    landed.append((op, recv[me], host))
            if p2p:
                for req in dist.batch_isend_irecv(p2p):
                    req.wait()
            for op, rows, received in landed:
                idx = _index(rows, row.device)
                received = stage.into(received)
                if op == "reduce":
                    received = accumulate(row[idx, cols], received, True)
                row[idx, cols] = received
                row[n_chunks].zero_()
    if stats is not None:
        if row.device.type != "cpu":
            torch.cuda.synchronize(row.device)
        stats.update(wall_s=time.perf_counter() - t_start,
                     stage_s=stage.seconds,
                     rounds=len(schedule.rounds) * max(1, schedule.chunk_factor))
    return row[:n_chunks]


def gather_rows(row: torch.Tensor, schedule: LoweredSchedule,
                mesh: PlannedMesh) -> Optional[torch.Tensor]:
    """Every process's final row, in rank order, at the process of group
    rank 0: ``[n, n_chunks, chunk_len]`` on ``row``'s device, what the
    virtual-mesh runner returns; None on the other processes.  One gather
    over the host; for tests and checks."""
    group = mesh.group
    host = row.detach().to("cpu").contiguous()
    root = dist.get_global_rank(group, 0)
    if dist.get_rank(group) != 0:
        dist.gather(host, None, dst=root, group=group)
        return None
    rows = [torch.empty_like(host) for _ in range(schedule.n)]
    dist.gather(host, rows, dst=root, group=group)      # by group rank
    by_position = torch.stack([rows[g] for g in mesh.order])
    return by_position[torch.as_tensor(schedule.order)].to(row.device)
