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
  accumulate over peer memory, in the ring order ``perm``, with flag
  signalling between the blocks of the one launch.  Only the single-card
  loopback mode is built (all n ranks' buffers on one card).  It equals
  :func:`ring_reduce_scatter` bit for bit in f32 and bf16: the same
  additions in the same order, each rounded once.  On CPU tensors it runs
  :func:`remote_ring_reduce_scatter_plain`.  The reference kernel is not a
  reduce-scatter (it forwards running sums, ROADMAP.md §3), so the port is
  held to ``ring_reduce_scatter_ref`` and to :func:`ring_reduce_scatter`,
  never to its arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

__all__ = ["fused_add", "fused_add_plain", "remote_ring_reduce_scatter",
           "remote_ring_reduce_scatter_plain", "ring_all_reduce",
           "ring_reduce_scatter", "ring_status", "ring_work", "work"]

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
    kernel or raises; on CPU tensors it runs :func:`fused_add_plain`.
    ``fused_add.launches`` counts kernel launches.
    """
    if a.shape != b.shape:
        raise ValueError(f"fused_add needs equal shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        res = fused_add_plain(a, b)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"fused_add runs on cuda or cpu, not {a.device}")
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


def ring_work(n: int, L: int, itemsize: int) -> Tuple[int, int]:
    """Bytes of one ``[n, L]`` reduce-scatter: ``(ring, function)``.

    ``ring``: what the ring moves in loopback, ``3 (n-1) L itemsize`` (each
    of n-1 rounds, each rank reads its predecessor's partial and its own
    chunk and writes its partial).  ``function``: what the function must
    move, ``(n + 1) L itemsize`` (x read once, the output written once),
    which a plain ``x.sum(0)`` comes close to.
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


#: (device index, n) -> (flags [n, max_blocks] int32, max_blocks)
_ring_flags: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
#: device index -> status word [1] int32 (0 = ok, 1 = a spin timed out)
_ring_status: Dict[int, torch.Tensor] = {}


def _ring_state(device: torch.device, n: int, lib: ctypes.CDLL
                ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Flags and status of ``device``, allocated once and cached.

    The flags are zero when allocated and only the kernel touches them
    after that; each rank has room for the most blocks a launch may give
    it, so one allocation serves every shape and ring order at this n.
    """
    key = (device.index, n)
    if key not in _ring_flags:
        most = ctypes.c_int(0)
        err = lib.peer_ring_max_blocks(n, ctypes.byref(most))
        if err or most.value < 1:
            raise RuntimeError(f"peer_ring: no room for {n} resident ranks "
                               f"(CUDA error {err}, {most.value} blocks)")
        _ring_flags[key] = (torch.zeros((n, most.value), dtype=torch.int32,
                                        device=device), most.value)
    if device.index not in _ring_status:
        _ring_status[device.index] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
    flags, most = _ring_flags[key]
    return flags, most, _ring_status[device.index]


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
    (loopback: all ranks' buffers on this card) or raises.  The
    kernel's status word reports a timed-out spin after a synchronise
    (:func:`ring_status`).  Launches at one n on one card share their
    flags, so they must not run at once: issue them on one stream.  On
    CPU tensors it runs :func:`remote_ring_reduce_scatter_plain`.
    ``remote_ring_reduce_scatter.launches`` counts kernel launches.
    """
    n, C, perm, _ = _ring_plan(x, perm)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the ring takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the ring needs a contiguous x")
    if x.device.type == "cpu":
        return remote_ring_reduce_scatter_plain(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"the ring runs on cuda or cpu, not {x.device}")
    lib = _ring_lib()
    out = torch.empty((n, C), dtype=x.dtype, device=x.device)
    scratch = torch.empty((n, (n - 2) * C), dtype=x.dtype, device=x.device)
    item = x.element_size()
    rows = (ctypes.c_ulonglong * n)
    with torch.cuda.device(x.device):
        flags, most, status = _ring_state(x.device, n, lib)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.peer_ring_fwd(
            _DTYPE_CODE[x.dtype], n, (ctypes.c_int * n)(*perm),
            rows(*(x.data_ptr() + r * n * C * item for r in range(n))),
            rows(*(scratch.data_ptr() + r * (n - 2) * C * item
                   for r in range(n))),
            rows(*(out.data_ptr() + r * C * item for r in range(n))),
            rows(*(flags.data_ptr() + r * most * 4 for r in range(n))),
            C, most, status.data_ptr(), stream)
    if err:
        raise RuntimeError(f"peer_ring kernel launch failed: CUDA error {err}")
    remote_ring_reduce_scatter.launches += 1
    return out


remote_ring_reduce_scatter.launches = 0
