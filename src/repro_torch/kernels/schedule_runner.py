"""Execute a certified :class:`LoweredSchedule` on the virtual mesh.

Counterpart of ``repro.kernels.schedule_runner``.  The reference runs a
schedule over a JAX mesh with ``ppermute``; the port runs it on one card,
where the n ranks are the leading dimension of one tensor (the *virtual
mesh*), so a permute step over its links ``(s, d)`` is an index gather:
``received[d] = payload[s]``, and zeros for a position that receives
nothing.  The semantics are the reference's, and the translation
validator's (:mod:`repro_torch.analysis.equiv`):

* position p holds logical rank ``schedule.rank_of[p]``'s buffer; the
  output goes back to rank order through ``schedule.order``;
* rounds are barriers: every step's payload is gathered from the
  round-entry state, then all staged receives are applied;
* a link ``(s, d)`` fires iff ``send_mask[s] and recv_mask[d]``;
* ``reduce`` reads the target rows, adds through
  :func:`~repro_torch.kernels.ring_collective.fused_add` and *writes*
  them back (no ``index_add_``: it would sum duplicate indices, which the
  reference does not); ``copy`` overwrites them;
* ``chunk_factor`` k splits every chunk into k column slices, run one
  after the other (piece-major here, round-major in
  :mod:`~repro_torch.kernels.overlap`; both give the same bits).

The state is ``[n, n_chunks + 1, chunk_len]``, position-major: row
``n_chunks`` is a zero scratch row that absorbs the gathers and scatters
of non-participating positions; it is zeroed again after every apply.

The runner trusts its schedule: schedules come from
:func:`~repro_torch.train.overlap_grads.certified_allreduce` or another
path where :func:`repro_torch.analysis.require_certified` has proved
them against their program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.collective.executors import LoweredSchedule

from .ring_collective import accumulate

__all__ = ["run_schedule", "check_postcondition", "schedule_tables",
           "seed_state", "finish_state", "fill_row", "row_shape"]


def _step_tables(step, n: int, n_chunks: int):
    """Static gather/scatter tables of one PermuteStep.

    Returns ``(eff_links, SEND, RECV)``: the mask-filtered link list and
    ``[n, m]`` int32 chunk-row tables (pad entries point at the zero
    scratch row ``n_chunks``).
    """
    m = max((len(c) for c in step.chunks), default=0)
    m = max(m, 1)
    send = np.full((n, m), n_chunks, dtype=np.int32)
    recv = np.full((n, m), n_chunks, dtype=np.int32)
    eff_links: List[Tuple[int, int]] = []
    for (s, d), chunks in zip(step.links, step.chunks):
        if not (step.send_mask[s] and step.recv_mask[d]):
            continue
        eff_links.append((int(s), int(d)))
        send[s, :len(chunks)] = chunks
        recv[d, :len(chunks)] = chunks
    return eff_links, send, recv


@functools.lru_cache(maxsize=256)
def schedule_tables(schedule: LoweredSchedule):
    """Static per-round ``(eff_links, SEND, RECV)`` tables + op tags.

    Memoised on the schedule *value* (frozen dataclasses hash by content,
    so two lowerings of one program share an entry): a train step runs
    the same certified schedule for every bucket of every step.  Returns
    ``(tables, ops)``; ``tables[r][s]`` is :func:`_step_tables` of round
    ``r``'s step ``s`` and ``ops[r][s]`` its reduce/copy tag.  The arrays
    are read-only by convention.
    """
    tables = tuple(
        tuple(_step_tables(step, schedule.n, schedule.n_chunks)
              for step in rnd)
        for rnd in schedule.rounds)
    ops = tuple(tuple(step.op for step in rnd) for rnd in schedule.rounds)
    return tables, ops


@dataclasses.dataclass(frozen=True)
class _Step:
    """One live permute step as index tensors on the state's device."""

    op: str
    all_receive: bool           # every position has a live inbound link
    dst: torch.Tensor           # [L] receiving positions
    src: torch.Tensor           # [L, 1] their senders
    send: torch.Tensor          # [L, m] the chunk rows each sender sends
    recv: torch.Tensor          # [n, m] the chunk rows each position lands
    rows: torch.Tensor          # [n, 1] every position


@functools.lru_cache(maxsize=64)
def device_tables(schedule: LoweredSchedule, device: torch.device
                  ) -> Tuple[Tuple[_Step, ...], ...]:
    """:func:`schedule_tables` as index tensors on ``device``, live steps only.

    Cached per (schedule, device), so a step's index tensors are copied to
    the card once, not once per bucket.  When every position receives,
    the links are listed in destination order, so the gather of the
    payloads is already the received tensor.  The tensors are made
    outside inference mode, so a run under grad may use tables a run
    under ``torch.inference_mode`` cached.
    """
    tables, ops = schedule_tables(schedule)
    n = schedule.n

    def t(a):
        with torch.inference_mode(False):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    out = []
    for rnd_tables, rnd_ops in zip(tables, ops):
        steps = []
        for (eff, send, recv), op in zip(rnd_tables, rnd_ops):
            if not eff:
                continue
            links = sorted(eff, key=lambda sd: sd[1])
            src = [s for s, _ in links]
            steps.append(_Step(
                op=op, all_receive=len(links) == n,
                dst=t([d for _, d in links]), src=t(src)[:, None],
                send=t(send[src]), recv=t(recv), rows=t(np.arange(n))[:, None]))
        out.append(tuple(steps))
    return tuple(out)


#: :func:`issue_round` calls running; see :func:`in_links`
_LINKS = [0]


def in_links() -> bool:
    """An :func:`issue_round` is running: the operations under way stand
    for the links, whose traffic is the collective's own (the dry run's
    byte counter leaves them to the collective's tally)."""
    return _LINKS[0] > 0


def issue_round(state: torch.Tensor, steps: Sequence[_Step],
                cols: slice) -> List[torch.Tensor]:
    """Gather and "send" one round's payloads from the current state.

    Returns one ``[n, m, piece_len]`` received tensor per live step:
    ``received[d] = payload[s]`` for each link ``(s, d)``, zeros where no
    link lands.  The gathers copy, so the staged receives hold the
    round-entry values whatever is applied afterwards.
    """
    view = state[:, :, cols]
    out = []
    _LINKS[0] += 1
    try:
        for st in steps:
            payload = view[st.src, st.send]             # [L, m, piece_len]
            if st.all_receive:
                out.append(payload)
                continue
            received = view.new_zeros((state.shape[0], *payload.shape[1:]))
            received[st.dst] = payload
            out.append(received)
    finally:
        _LINKS[0] -= 1
    return out


def apply_round(state: torch.Tensor, steps: Sequence[_Step],
                staged: Sequence[torch.Tensor], cols: slice,
                n_chunks: int, use_kernel_add: bool) -> None:
    """Land one round's staged receives in ``state`` (in place).

    ``reduce`` reads the target rows, accumulates and writes them back;
    ``copy`` overwrites them.  The scratch row absorbs the zero receives
    of positions no link reaches, and is zeroed again after every step.
    """
    view = state[:, :, cols]
    for st, received in zip(steps, staged):
        if st.op == "reduce":
            new = accumulate(view[st.rows, st.recv], received, use_kernel_add)
        else:
            new = received
        view[st.rows, st.recv] = new
        state[:, n_chunks].zero_()


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def row_shape(schedule: LoweredSchedule, width: int) -> Tuple[int, int]:
    """``(n_chunks + 1, chunk_len)`` of a position's row for inputs of
    ``width`` elements a rank, shaped by the schedule's declared init
    (``replicated``: the full local vector; ``sharded``: rank r's own
    chunk; ``addressed``: the n outgoing pieces)."""
    n, n_chunks = schedule.n, schedule.n_chunks
    if schedule.init == "replicated":
        if width % n_chunks:
            raise ValueError(f"D={width} not divisible by "
                             f"n_chunks={n_chunks}")
        return n_chunks + 1, width // n_chunks
    if schedule.init == "sharded":
        return n_chunks + 1, width
    if schedule.init == "addressed":
        if n_chunks != n * n or width % n:
            raise ValueError(f"addressed init wants n_chunks=n^2 and "
                             f"D divisible by n, got D={width}")
        return n_chunks + 1, width // n
    raise ValueError(f"unknown init {schedule.init!r}")


def fill_row(row: torch.Tensor, schedule: LoweredSchedule, rank: int,
             xr: torch.Tensor) -> None:
    """Seed one position's ``[n_chunks + 1, chunk_len]`` row (in place)
    from logical rank ``rank``'s input ``xr``: the full vector
    (``replicated``; the scratch row zeroed), its own chunk (``sharded``)
    or its n outgoing pieces (``addressed``) into a zeroed row."""
    n, n_chunks = schedule.n, schedule.n_chunks
    if schedule.init == "replicated":
        row[:n_chunks] = xr.reshape(n_chunks, row.shape[-1])
        row[n_chunks].zero_()
        return
    row.zero_()
    if schedule.init == "sharded":
        row[rank] = xr
    else:
        row[rank * n:(rank + 1) * n] = xr.reshape(n, row.shape[-1])


def seed_state(schedule: LoweredSchedule, x) -> torch.Tensor:
    """Position-major ``[n, n_chunks + 1, chunk_len]`` state from inputs.

    ``x`` is ``[n, D]`` rank-major (see :func:`row_shape`).  The state
    lies on ``x``'s device, in its dtype; position p's row is filled
    straight from rank ``rank_of[p]``'s input, one copy of the payload.
    """
    n = schedule.n
    x = _as_tensor(x)
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"want [n={n}, D] rank-major inputs, "
                         f"got {tuple(x.shape)}")
    buf = x.new_empty((n, *row_shape(schedule, x.shape[1])))
    for p, r in enumerate(schedule.rank_of):
        fill_row(buf[p], schedule, r, x[r])
    return buf


def finish_state(schedule: LoweredSchedule, state: torch.Tensor) -> torch.Tensor:
    """Back to rank space, scratch row dropped: ``[n, n_chunks, chunk_len]``."""
    order = torch.as_tensor(schedule.order, device=state.device)
    return state[order][:, :schedule.n_chunks]


def piece_slices(chunk_len: int, k: int) -> List[slice]:
    """The ``chunk_factor`` column slices of a chunk."""
    if chunk_len % k:
        raise ValueError(
            f"chunk_len {chunk_len} not divisible by chunk_factor {k}")
    w = chunk_len // k
    return [slice(p * w, (p + 1) * w) for p in range(k)]


def run_schedule(x, schedule: LoweredSchedule,
                 use_kernel_add: bool = True) -> torch.Tensor:
    """Run ``schedule`` on the virtual mesh; returns the final rank buffers.

    ``x``: ``[n, D]`` rank-major inputs (see :func:`seed_state`).
    Returns ``[n, n_chunks, chunk_len]`` rank-major — row r is logical
    rank r's final chunk buffer, against which the declared postcondition
    can be checked (:func:`check_postcondition`).  ``use_kernel_add=False``
    reduces with plain ``+`` instead of :func:`fused_add`.
    """
    state = seed_state(schedule, x)
    steps = device_tables(schedule, state.device)
    for cols in piece_slices(state.shape[-1], max(1, schedule.chunk_factor)):
        for rnd in steps:
            staged = issue_round(state, rnd, cols)
            apply_round(state, rnd, staged, cols, schedule.n_chunks,
                        use_kernel_add)
    return finish_state(schedule, state)


def _np64(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().to("cpu", torch.float64)
    return np.asarray(t, dtype=np.float64)


def check_postcondition(schedule: LoweredSchedule, x, out,
                        atol: float = 1e-5) -> List[str]:
    """Numerically verify ``out`` satisfies the declared postcondition.

    ``x``/``out`` as in :func:`run_schedule` (tensors or arrays).  Returns
    human-readable mismatch descriptions (empty list = postcondition
    holds) — the numeric complement of the symbolic bisimulation proof.
    """
    n, n_chunks = schedule.n, schedule.n_chunks
    x = _np64(x)
    out = _np64(out)
    post = schedule.postcondition
    bad: List[str] = []

    def close(a, b) -> bool:
        return bool(np.allclose(a, b, atol=atol, rtol=1e-5))

    if post in ("allreduce", "reduce"):
        want = x.sum(axis=0).reshape(n_chunks, -1)   # replicated init
        if post == "allreduce":
            for r in range(n):
                if not close(out[r], want):
                    bad.append(f"rank {r}: allreduce result diverges")
        else:
            if not any(close(out[r], want) for r in range(n)):
                bad.append("no rank holds the fully-reduced vector")
    elif post == "reduce_scatter":
        want = x.sum(axis=0).reshape(n_chunks, -1)
        for r in range(n):
            if not close(out[r, r], want[r]):
                bad.append(f"rank {r}: chunk {r} not fully reduced")
    elif post == "all_gather":
        for r in range(n):
            for c in range(n_chunks):
                if not close(out[r, c], x[c]):
                    bad.append(f"rank {r}: chunk {c} not gathered")
    elif post == "all_to_all":
        piece = x.reshape(n, n, -1)                  # [src, dst, len]
        for s in range(n):
            for d in range(n):
                if not close(out[d, s * n + d], piece[s, d]):
                    bad.append(f"piece {s}→{d} undelivered")
    elif post != "none":
        bad.append(f"unknown postcondition {post!r}")
    return bad
