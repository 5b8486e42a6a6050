"""The accumulate kernel and the rank-reordered ring on the virtual mesh.

Counterpart of ``repro.kernels.ring_collective``:

* :func:`fused_add` — ``(a.f32 + b.f32)`` rounded once to ``a``'s dtype.
  On CUDA tensors it launches ``csrc/fused_add.cu`` (CUDA C++ for
  sm_90a, bound with ``ctypes``), which replaces the TPU kernel
  ``_add_kernel`` / ``fused_add``; on CPU tensors it runs
  :func:`fused_add_plain`.  It is the reduce of every ring step and of
  every ``reduce`` step of :mod:`~repro_torch.kernels.schedule_runner`
  and :mod:`~repro_torch.kernels.overlap`.  ``out=a`` accumulates in
  place.
* :func:`ring_reduce_scatter` / :func:`ring_all_reduce` — the ring whose
  neighbour order is the solved rank permutation ``perm``, on the
  single-card *virtual mesh*: the n ranks are the leading dimension of
  one tensor, and the ``ppermute`` to the ring successor is an index
  gather over that dimension.

* :func:`remote_ring_reduce_scatter` — the same reduce-scatter as one
  launch of ``csrc/peer_ring.cu`` (CUDA C++ for sm_90a, bound with
  ``ctypes``), which replaces the TPU kernel ``_rdma_ring_kernel`` /
  ``remote_ring_reduce_scatter_tpu``: n-1 rounds of neighbour copy and
  accumulate over peer memory, in the ring order ``perm``, tile by tile
  through an L2-resident FIFO of slots with counter handshakes between
  the blocks of the one launch.  Only the single-card loopback mode is
  built (all n ranks' buffers on one card).  It equals
  :func:`ring_reduce_scatter` bit for bit in f32 and bf16: the same
  additions in the same order, each rounded once.  On CPU tensors it runs
  :func:`remote_ring_reduce_scatter_plain`.  The reference kernel is not a
  reduce-scatter (it forwards running sums, ROADMAP.md §3), so the port is
  held to ``ring_reduce_scatter_ref`` and to :func:`ring_reduce_scatter`,
  never to its arithmetic.  :func:`peer_ring_schedule_plain` walks the
  kernel's own schedule (tiles, rounds, FIFO slots, counters) on the CPU,
  so the CPU tests check the protocol as well as the sum.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import accounting, build

__all__ = ["RingState", "fused_add", "fused_add_plain",
           "peer_ring_schedule_plain", "remote_ring_reduce_scatter",
           "remote_ring_reduce_scatter_plain", "ring_all_reduce",
           "ring_fifo", "ring_reduce_scatter", "ring_status", "ring_work",
           "work"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a.f32 + b.f32).to(a.dtype)`` in PyTorch: the kernel's arithmetic."""
    return (a.float() + b.float()).to(a.dtype)


def work(n_elems: int, itemsize: int) -> int:
    """Bytes one call moves: ``a`` and ``b`` read once, ``out`` written once."""
    return 3 * n_elems * itemsize


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_add")
    fn = lib.fused_add_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(a: torch.Tensor, b: torch.Tensor,
                out: Optional[torch.Tensor]) -> None:
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_add takes float32 or bfloat16, not {a.dtype}")
    for name, x in (("b", b), ("out", out)):
        if x is None:
            continue
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if x.dtype != a.dtype:
            raise TypeError(f"{name} is {x.dtype}, a is {a.dtype}")
        if x.shape != a.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"a {tuple(a.shape)}")
    for name, x in (("a", a), ("b", b), ("out", out)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"fused_add needs contiguous tensors; {name} "
                             f"is not")


def fused_add(a: torch.Tensor, b: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise ``a + b`` summed in f32 and rounded once to ``a.dtype``.

    ``out`` (same shape, dtype and device; may be ``a`` itself) receives
    the result, else a new tensor does.  On CUDA tensors it launches the
    kernel or raises; on CPU tensors it runs :func:`fused_add_plain`; on
    meta tensors it launches nothing (:mod:`.accounting` tallies
    :func:`work` there and at each launch).
    ``fused_add.launches`` counts kernel launches.
    """
    if a.shape != b.shape:
        raise ValueError(f"fused_add needs equal shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        res = fused_add_plain(a, b)
        return res if out is None else out.copy_(res)
    if a.device.type == "meta":
        # the dry run: the kernel's work, no launch
        accounting.record("fused_add", lambda: (0, work(a.numel(),
                                                        a.element_size())))
        return torch.empty_like(a) if out is None else out
    if a.device.type != "cuda":
        raise ValueError(f"fused_add runs on cuda or cpu (and stands in on "
                         f"meta), not {a.device}")
    _check_cuda(a, b, out)
    if out is None:
        out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.fused_add_fwd(_DTYPE_CODE[a.dtype], a.data_ptr(),
                                b.data_ptr(), out.data_ptr(), a.numel(),
                                stream)
    if err:
        raise RuntimeError(f"fused_add kernel launch failed: CUDA error {err}")
    fused_add.launches += 1
    accounting.record("fused_add", lambda: (0, work(a.numel(),
                                                    a.element_size())))
    return out


fused_add.launches = 0


def accumulate(a: torch.Tensor, b: torch.Tensor,
               use_kernel_add: bool) -> torch.Tensor:
    """``a + b`` through :func:`fused_add` (into ``a``, which the caller
    owns) or, with ``use_kernel_add=False``, through plain ``+``."""
    if use_kernel_add:
        return fused_add(a, b, out=a)
    return a + b


def _ring_positions(perm: Sequence[int]) -> np.ndarray:
    n = len(perm)
    if sorted(int(p) for p in perm) != list(range(n)):
        raise ValueError(f"perm {list(perm)} is not a permutation of range({n})")
    pos_of = np.zeros(n, dtype=np.int64)
    for i, d in enumerate(perm):
        pos_of[int(d)] = i
    return pos_of


def ring_reduce_scatter(
    x: torch.Tensor,
    perm: Optional[Sequence[int]] = None,
    use_kernel_add: bool = True,
) -> torch.Tensor:
    """Reduce-scatter over the leading (rank) dimension with a reordered ring.

    ``x``: ``[n, L]`` (L % n == 0) — row d is rank d's full contribution.
    Returns ``[n, L // n]``: row d is the fully reduced chunk d.

    The schedule of ``ring_reduce_scatter`` in the reference, in ring
    position space (position i = ``pos_of[rank]``): at step s, position i
    forwards its partial sum to position i + 1 (the link
    ``perm[i] -> perm[i+1]``), and the receiver adds its own
    contribution to chunk ``perm[(i - s - 2) mod n]``.  After n-1 steps
    rank d holds chunk d whatever the ring order.  Each step is one
    gather over ranks and one :func:`fused_add` over all n rows.
    """
    n, L = x.shape
    if L % n:
        raise ValueError(f"row length {L} is not a multiple of n={n}")
    perm = list(range(n)) if perm is None else [int(p) for p in perm]
    pos_of = _ring_positions(perm)
    perm_a = np.asarray(perm, dtype=np.int64)
    # perm[pos_of[d] - 1] is both rank d's ring predecessor (whose buffer
    # d receives) and the chunk d starts with
    prev = torch.as_tensor(perm_a[(pos_of - 1) % n], device=x.device)
    rows = torch.arange(n, device=x.device)
    chunks = x.reshape(n, n, L // n)              # [rank, chunk, L/n]
    buf = chunks[rows, prev]                      # [n, L/n]
    for s in range(n - 1):
        received = buf[prev]
        mine = chunks[rows, torch.as_tensor(perm_a[(pos_of - s - 2) % n],
                                            device=x.device)]
        buf = accumulate(received, mine, use_kernel_add)
    return buf


def ring_all_reduce(x: torch.Tensor, perm: Optional[Sequence[int]] = None,
                    **kw) -> torch.Tensor:
    """Reduce-scatter + all-gather: ``[n, L]``, every row the full sum.

    The chunks arrive in rank order (see :func:`ring_reduce_scatter`), so
    the all-gather is one concatenation broadcast to every rank.
    """
    n = x.shape[0]
    rs = ring_reduce_scatter(x, perm=perm, **kw)
    return rs.reshape(1, -1).expand(n, -1).contiguous()


# -- the peer-memory ring (csrc/peer_ring.cu) --------------------------------

#: largest ring the kernel's descriptor table holds
MAX_RING = 32
#: the kernel's schedule, the same constants as ``csrc/peer_ring.cu``'s
#: (a test holds them equal): bytes a tile (a FIFO slot), FIFO slots a
#: block; all ranks' FIFOs together stay within ``RING_FIFO_BUDGET``, and
#: the FIFO is allocated here from them
RING_TILE_BYTES, RING_SLOTS = 16384, 2
RING_FIFO_BUDGET = 16 << 20


def ring_work(n: int, L: int, itemsize: int) -> Tuple[int, int]:
    """Bytes of one ``[n, L]`` reduce-scatter: ``(ring, function)``.

    ``ring``: what a ring moves in loopback, ``3 (n-1) L itemsize`` (each
    of n-1 rounds, each rank reads its predecessor's partial and its own
    chunk and writes its partial); the kernel keeps the partials in an
    L2-resident FIFO, so of these only the function's reach device
    memory.  ``function``: what the function must move, ``(n + 1) L
    itemsize`` (x read once, the output written once), which a plain
    ``x.sum(0)`` comes close to.
    """
    return 3 * (n - 1) * L * itemsize, (n + 1) * L * itemsize


def _ring_plan(x: torch.Tensor, perm: Optional[Sequence[int]]
               ) -> Tuple[int, int, list, np.ndarray]:
    if x.dim() != 2:
        raise ValueError(f"the ring takes [n, L], got shape {tuple(x.shape)}")
    n, L = x.shape
    if n < 2 or n > MAX_RING:
        raise ValueError(f"the ring takes 2 to {MAX_RING} ranks, got {n}")
    if L % n:
        raise ValueError(f"row length {L} is not a multiple of n={n}")
    perm = list(range(n)) if perm is None else [int(p) for p in perm]
    if len(perm) != n:
        raise ValueError(f"perm has {len(perm)} entries for {n} ranks")
    return n, L // n, perm, _ring_positions(perm)


def remote_ring_reduce_scatter_plain(
    x: torch.Tensor, perm: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The kernel's rounds in PyTorch, rank by rank in ring order.

    Round s: the rank at ring position i adds its own chunk
    ``perm[(i - s - 2) mod n]`` to what its predecessor ``perm[i - 1]``
    holds (round 0: the predecessor's input chunk; later rounds: its
    partial of the round before), in f32, rounded once.  Returns
    ``[n, L // n]``; row d is the reduced chunk d.
    """
    n, C, perm, pos_of = _ring_plan(x, perm)
    rows = x.reshape(n, n, C)
    partial = None
    for s in range(n - 1):
        cur = []
        for r in range(n):
            i = int(pos_of[r])
            p, c = perm[(i - 1) % n], perm[(i - s - 2) % n]
            recv = rows[p, c] if s == 0 else partial[p]
            cur.append(fused_add_plain(recv, rows[r, c]))
        partial = cur
    return torch.stack(partial)


class RingState:
    """What a card keeps for the ring at one n between launches, as
    :func:`peer_ring_schedule_plain` models it: each (rank, block)'s two
    counters, ``produced`` and ``consumed`` (``counters[rank, 0|1,
    block]``, zero at first), and each block's FIFO of ``slots`` tiles.
    ``log`` gets one record a launch (see :func:`peer_ring_schedule_plain`).
    """

    def __init__(self, n: int, max_blocks: int, slots: int = RING_SLOTS):
        if slots < 2:
            raise ValueError("the ring's FIFO needs at least 2 slots")
        self.n, self.max_blocks, self.slots = n, max_blocks, slots
        self.counters = np.zeros((n, 2, max_blocks), dtype=np.int64)
        #: (rank, block, slot) -> [absolute write index, read?, tile]
        self.fifo: Dict[Tuple[int, int, int], list] = {}
        self.log: list = []


def peer_ring_schedule_plain(
    x: torch.Tensor, perm: Optional[Sequence[int]] = None, *,
    state: RingState, tile_bytes: int = RING_TILE_BYTES, seed: int = 0,
) -> torch.Tensor:
    """The kernel's schedule in PyTorch: the same grid, tiles, rounds, FIFO
    slots and counters, its blocks interleaved in a seeded random order.

    Mirrors ``peer_ring_fwd``: units of 16 bytes where the chunk allows
    (else scalars), ``tile_bytes`` a tile, B = min(tiles, max_blocks)
    blocks a rank of ceil(units / B) units each; block (j, r) runs round s
    of tile k only when its waits hold (the predecessor's ``produced`` for
    a FIFO read, the successor's ``consumed`` for a FIFO write), from the
    bases it reads from ``state`` at the launch's start.  Returns the
    reduce-scatter, which equals :func:`ring_reduce_scatter` bit for bit.
    Appends to ``state.log`` what the launch saw: ``blocks``, ``tiles``
    (a slice), ``equal_at_start`` (all ranks' counters of each slice it
    uses equal when it starts), ``advance`` (each slice's counters after
    minus before, per rank and counter), ``overwrites_unread`` (FIFO
    writes onto a slot whose tenant was not yet read) and ``bad_reads``
    (FIFO reads that found another write than the one they wait for).
    Raises if no block can move (a deadlock).
    """
    n, C, perm, pos_of = _ring_plan(x, perm)
    if state.n != n:
        raise ValueError(f"the state is for n={state.n}, x has {n} ranks")
    item = x.element_size()
    per_vec = 16 // item
    unit = per_vec if C % per_vec == 0 and x.data_ptr() % 16 == 0 else 1
    units = C // unit
    tile = max(1, tile_bytes // (unit * item))        # units a tile
    blocks = min(-(-units // tile), state.max_blocks)
    per_block = -(-units // blocks)
    spans = [(j * per_block, min((j + 1) * per_block, units))
             for j in range(blocks)]
    tiles = [max(0, -(-(hi - lo) // tile)) for lo, hi in spans]
    cnt, K = state.counters, state.slots
    before = cnt[:, :, :blocks].copy()
    rec = {"blocks": blocks, "tiles": tiles,
           "equal_at_start": all(bool((before[:, :, j] == before[0, 0, j]).all())
                                 for j in range(blocks) if tiles[j]),
           "overwrites_unread": 0, "bad_reads": 0}
    rows = x.reshape(n, n, C)
    out = torch.empty((n, C), dtype=x.dtype, device=x.device)
    step = {(r, j): 0 for r in range(n) for j in range(blocks) if tiles[j]}

    def where(r, j):
        k, s = divmod(step[(r, j)], n - 1)
        i = int(pos_of[r])
        return k, s, k * (n - 2) + s, i, perm[(i - 1) % n], perm[(i + 1) % n]

    def ready(r, j):
        k, s, w, i, pd, nx = where(r, j)
        if s >= 1 and cnt[pd, 0, j] < before[r, 1, j] + w:
            return False
        return not (s <= n - 3 and w >= K
                    and cnt[nx, 1, j] < before[r, 0, j] + w - K + 1)

    rng = np.random.default_rng(seed)
    while step:
        live = [b for b in step if ready(*b)]
        if not live:
            raise RuntimeError(f"peer_ring schedule: no block can move "
                               f"(steps {step})")
        r, j = live[int(rng.integers(len(live)))]
        k, s, w, i, pd, _ = where(r, j)
        base_p, base_c = before[r, 0, j], before[r, 1, j]
        lo = (spans[j][0] + k * tile) * unit
        hi = min(spans[j][1], spans[j][0] + (k + 1) * tile) * unit
        c = perm[(i - s - 2) % n]
        if s == 0:
            recv = rows[pd, c, lo:hi]
        else:
            slot = state.fifo[(pd, j, (w - 1) % K)]
            if slot[0] != base_c + w - 1 or slot[1]:
                rec["bad_reads"] += 1
            slot[1] = True
            recv = slot[2]
            cnt[r, 1, j] = base_c + w
        z = fused_add_plain(recv, rows[r, c, lo:hi])
        if s <= n - 3:
            old = state.fifo.get((r, j, w % K))
            if old is not None and not old[1]:
                rec["overwrites_unread"] += 1
            state.fifo[(r, j, w % K)] = [base_p + w, False, z]
            cnt[r, 0, j] = base_p + w + 1
        else:
            out[r, lo:hi] = z
        step[(r, j)] += 1
        if step[(r, j)] == tiles[j] * (n - 1):
            del step[(r, j)]
    rec["advance"] = cnt[:, :, :blocks] - before
    state.log.append(rec)
    return out


def _ring_lib() -> ctypes.CDLL:
    lib = build.library("peer_ring")
    if lib.peer_ring_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.peer_ring_max_blocks.argtypes = [i, ctypes.POINTER(i)]
        lib.peer_ring_max_blocks.restype = i
        lib.peer_ring_fwd.argtypes = [i, i, p, p, p, p, p,
                                      ctypes.c_longlong, i, p, p]
        lib.peer_ring_fwd.restype = i
    return lib


#: (device index, n) -> (counters [n, 2, max_blocks] int32, FIFO [n, bytes]
#: uint8, max_blocks)
_ring_flags: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, int]] = {}
#: device index -> status word [1] int32 (0 = ok, 1 = a spin timed out)
_ring_status: Dict[int, torch.Tensor] = {}


def _ring_state(device: torch.device, n: int, lib: ctypes.CDLL
                ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """Counters, FIFO and status of ``device`` at ``n``, allocated once and
    cached.

    The counters are zero when allocated and only the kernel touches them
    after that; each rank has room for the most blocks a launch may give
    it, so one allocation serves every shape and ring order at this n.  The
    FIFO (``max_blocks x slots x tile_bytes`` a rank; none at n = 2) does
    not depend on L, and a captured graph replays on it.
    """
    key = (device.index, n)
    if key not in _ring_flags:
        most = ctypes.c_int(0)
        err = lib.peer_ring_max_blocks(n, ctypes.byref(most))
        if err or most.value < 1:
            raise RuntimeError(f"peer_ring: no room for {n} resident ranks "
                               f"(CUDA error {err}, {most.value} blocks)")
        per_rank = most.value * RING_SLOTS * RING_TILE_BYTES if n > 2 else 0
        _ring_flags[key] = (
            torch.zeros((n, 2, most.value), dtype=torch.int32, device=device),
            torch.empty((n, per_rank), dtype=torch.uint8, device=device),
            most.value)
    if device.index not in _ring_status:
        _ring_status[device.index] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
    flags, fifo, most = _ring_flags[key]
    return flags, fifo, most, _ring_status[device.index]


def ring_fifo(n: int, device=None) -> Dict[str, int]:
    """The FIFO on ``device`` at ``n`` (allocating it if no launch has):
    ``tile_bytes`` and ``slots`` (the schedule's constants),
    ``blocks_per_rank`` (the card's) and ``bytes`` (all ranks' FIFOs as
    allocated)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lib = _ring_lib()
    with torch.cuda.device(dev):
        _, fifo, most, _ = _ring_state(dev, n, lib)
    return dict(tile_bytes=RING_TILE_BYTES, slots=RING_SLOTS,
                blocks_per_rank=most, bytes=fifo.numel())


def ring_status(device=None) -> int:
    """The kernel's status word on ``device`` (synchronises): 0 if no
    launch has timed out since the state was allocated, else 1."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    st = _ring_status.get(dev.index)
    return 0 if st is None else int(st.item())


def remote_ring_reduce_scatter(
    x: torch.Tensor, perm: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Reduce-scatter of ``x`` ``[n, L]`` over a ring in order ``perm``.

    Row d of ``x`` is rank d's contribution; returns ``[n, L // n]``, row
    d the fully reduced chunk d — :func:`ring_reduce_scatter`'s result,
    bit for bit.  It takes float32 or bfloat16, contiguous, ``L % n ==
    0``, 2 to 32 ranks, and raises on anything else, on either device.
    On CUDA tensors it makes one launch of the peer-memory ring kernel
    (loopback: all ranks' buffers on this card) or raises; the partials
    pass through a FIFO cached per (card, n), so nothing is allocated but
    the output.  The kernel's status word reports a timed-out spin after a
    synchronise (:func:`ring_status`).  Launches at one n on one card
    share their counters and FIFO, so they must not run at once: issue
    them on one stream.  On CPU tensors it runs
    :func:`remote_ring_reduce_scatter_plain`.
    ``remote_ring_reduce_scatter.launches`` counts kernel launches.
    """
    n, C, perm, _ = _ring_plan(x, perm)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the ring takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the ring needs a contiguous x")
    if x.device.type == "cpu":
        return remote_ring_reduce_scatter_plain(x, perm)
    if x.device.type == "meta":
        # the dry run: the function's bytes, no launch
        accounting.record("peer_ring", lambda: (0, ring_work(
            n, C * n, x.element_size())[1]))
        return x.new_empty((n, C))
    if x.device.type != "cuda":
        raise ValueError(f"the ring runs on cuda or cpu (and stands in on "
                         f"meta), not {x.device}")
    lib = _ring_lib()
    out = torch.empty((n, C), dtype=x.dtype, device=x.device)
    item = x.element_size()
    rows = (ctypes.c_ulonglong * n)
    with torch.cuda.device(x.device):
        flags, fifo, most, status = _ring_state(x.device, n, lib)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.peer_ring_fwd(
            _DTYPE_CODE[x.dtype], n, (ctypes.c_int * n)(*perm),
            rows(*(x.data_ptr() + r * n * C * item for r in range(n))),
            rows(*(fifo.data_ptr() + r * fifo.shape[1] for r in range(n))),
            rows(*(out.data_ptr() + r * C * item for r in range(n))),
            rows(*(flags.data_ptr() + r * 2 * most * 4 for r in range(n))),
            C, most, status.data_ptr(), stream)
    if err:
        raise RuntimeError(f"peer_ring kernel launch failed: CUDA error {err}")
    remote_ring_reduce_scatter.launches += 1
    accounting.record("peer_ring", lambda: (0, ring_work(n, C * n, item)[1]))
    return out


remote_ring_reduce_scatter.launches = 0
