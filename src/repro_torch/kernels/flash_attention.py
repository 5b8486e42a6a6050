"""Flash attention forward (causal / full / sliding window, GQA): the CUDA
kernel and its plain version.

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``repro/kernels/flash_attention.py``: blocked online-softmax attention on
``q [B, H, S, hd]`` and ``k``/``v [B, KV, S, hd]``, query head h reading
kv head ``h // (H // KV)``; running max ``m``, denominator ``l`` and
accumulator ``acc`` in f32; masked scores are ``-1e30`` (never ``-inf``);
rows with ``l == 0`` give 0.  The output comes back in ``q``'s dtype.

The kernels are in ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a,
bound with ``ctypes``); the dtype and head width alone choose one:

* ``flash_fwd_wgmma``: bf16 at head width 64 and 128, every dense config
  the port serves.  A block of three warpgroups owns 128 query rows: a
  producer thread feeds K/V tiles of 128 keys by TMA into a ring of
  shared memory (2 stages at head width 128, 4 at 64); two consumer
  warpgroups, 64 rows each, run
  ``wgmma`` for ``Q K^T`` and ``P V`` with the online softmax in
  registers between them.
* ``flash_fwd_mma``: bf16 at head width 16, 32 and 256, with
  ``mma.sync`` and ``cp.async`` double buffering.
* ``flash_fwd_fma``: f32, and bf16 at head width 8, in f32 FMA.

Each takes strides, so the model's transposed q/k/v views are read in
place, and any sequence length: the kernels mask their own ragged tail.
``block_q``/``block_k`` are the plain version's tiles; both paths check
them as the reference does (``S % min(block, S) == 0``).

What bounds it on an H100: at the dense serving path's prefill shape
(glm4-9b: B=8, H=32, KV=2, S=2048, hd=128, causal, bf16) a call does
2.75e11 FLOP on the tensor cores (0.28 ms at 989 TFLOP/s) and moves
285 MB (0.085 ms at 3.35 TB/s): it is bound by operations, which only
``wgmma`` issues at the tensor cores' full rate, and only when the loads
(TMA, a producer of their own) and the softmax overlap the products.
``flash_attention.launches`` counts every launch and
``flash_attention.kernel_launches`` each kernel's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import accounting, build

__all__ = ["HEAD_DIMS", "KERNELS", "flash_attention", "flash_attention_plain",
           "work"]

NEG_INF = -1e30
#: head widths the kernel is built for (8 to 256 cover every config)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels of ``csrc/flash_attention.cu``, by the code it reports
KERNELS = ("flash_fwd_fma", "flash_fwd_mma", "flash_fwd_wgmma")


def _check_args(q, k, v, block_q: int, block_k: int) -> Tuple[int, int]:
    """The reference's argument checks (``flash_attention.py:102-112``);
    returns the effective ``(block_q, block_k)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D [B, heads, S, hd]: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, hd) or tuple(v.shape) != (B, KV, S, hd):
        raise ValueError(f"k and v must be [B, KV, S, hd] = [{B}, KV, {S}, "
                         f"{hd}]: {tuple(k.shape)} {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KV}")
    block_q, block_k = min(block_q, S), min(block_k, S)
    if block_q < 1 or block_k < 1 or S % block_q or S % block_k:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"block_q={block_q} and block_k={block_k}")
    return block_q, block_k


def flash_attention_plain(
    q: torch.Tensor,           # [B, H, S, hd]
    k: torch.Tensor,           # [B, KV, S, hd]
    v: torch.Tensor,           # [B, KV, S, hd]
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """The Pallas kernel's algorithm in PyTorch, all in f32: an online
    softmax over key blocks of ``block_k`` (all query rows at once; the
    rows are independent, so ``block_q`` only enters the checks)."""
    _, block_k = _check_args(q, k, v, block_q, block_k)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, H // KV, S, hd).float()
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, H // KV, S), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j in range(0, S, block_k):
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf[:, :, j:j + block_k]) * sm_scale
        if causal or window:
            rel = q_pos[:, None] - q_pos[None, j:j + block_k]
            mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
            if window:
                mask = mask & (rel < window)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[:, :, None, j:j + block_k]
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, H, S, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def valid_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, for one (batch row, head)."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        total += max(0, hi - lo)
    return total


def work(B: int, H: int, KV: int, S: int, hd: int, causal: bool, window: int,
         itemsize: int = 2) -> Tuple[int, int]:
    """``(flops, bytes)`` one call needs: a multiply-add counted as 2 for
    ``q k^T`` and ``p v`` over the unmasked pairs only; q, k, v read once
    and the output written once."""
    flops = 4 * hd * B * H * valid_pairs(S, causal, window)
    moved = (2 * B * H * S * hd + 2 * B * KV * S * hd) * itemsize
    return flops, moved


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                       p, p, ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {q.shape[-1]}")


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x`` starts on 16 bytes (the kernels' vector
    loads and tensor maps) and its last dimension is contiguous: each
    stride of a dimension longer than 1 a positive multiple of 16 bytes."""
    e = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.shape[d] == 1 or (x.stride(d) > 0
                                        and (x.stride(d) * e) % 16 == 0)
                    for d in range(3)))


def flash_attention(
    q: torch.Tensor,           # [B, H, S, hd]
    k: torch.Tensor,           # [B, KV, S, hd]
    v: torch.Tensor,           # [B, KV, S, hd]
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Attention forward ``[B, H, S, hd]`` in ``q``'s dtype.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`flash_attention_plain`; on meta tensors it launches
    nothing and returns an empty output (:mod:`.accounting` tallies
    :func:`work` there and at each launch).  ``flash_attention.launches``
    counts kernel launches, ``flash_attention.kernel_launches[name]``
    those of each kernel of :data:`KERNELS`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale, block_q=block_q,
                                     block_k=block_k)
    if q.device.type == "meta":
        # the dry run: the kernel's work and an empty output, no launch
        _check_args(q, k, v, block_q, block_k)
        accounting.record("flash_attention", lambda: work(
            *q.shape[:2], k.shape[1], q.shape[2], q.shape[3], causal,
            window, q.element_size()))
        return q.new_empty(q.shape)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu (and stands "
                         f"in on meta), not {q.device}")
    _check_args(q, k, v, block_q, block_k)
    _check_cuda(q, k, v)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    # rows that do not start on 16 bytes are copied (never on the model's
    # path: its q/k are fresh RoPE outputs and v a transposed view whose
    # rows are H_kv * hd elements apart)
    q, k, v = (x if _rows_aligned(x) else x.contiguous() for x in (q, k, v))
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(x.stride(d) for x in (q, k, v)
                                         for d in range(3)))
    lib = _lib()
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, KV, S, hd, int(bool(causal)), int(window),
            float(sm_scale), strides, stream, ctypes.byref(kernel))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} ({KERNELS[kernel.value]})")
    flash_attention.launches += 1
    flash_attention.kernel_launches[KERNELS[kernel.value]] += 1
    accounting.record("flash_attention", lambda: work(
        B, H, KV, S, hd, causal, window, q.element_size()))
    return out


flash_attention.launches = 0
flash_attention.kernel_launches = dict.fromkeys(KERNELS, 0)
