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

The reference's remote-DMA ring (``remote_ring_reduce_scatter_tpu``)
needs peer memory across cards and is still to be ported (ROADMAP.md §2).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import build

__all__ = ["fused_add", "fused_add_plain", "ring_all_reduce",
           "ring_reduce_scatter", "work"]

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
