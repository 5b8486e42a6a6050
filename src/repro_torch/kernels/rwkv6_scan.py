"""RWKV6 WKV as the exact token recurrence: the CUDA kernel and its plain version.

Replaces the TPU kernel ``_wkv_kernel`` / ``wkv_scan`` of
``repro/kernels/rwkv6_scan.py``: from a fresh zero ``[K, V]`` f32 state,
token by token inside ``chunk``-token blocks,

    y_t = sum_k (S + u (.) k_t v_t^T) . r_t,    then    S = w_t (.) S + k_t v_t^T

with every product in f32 and y in ``v.dtype``.  Unlike the chunk form
(:mod:`.rwkv6_chunked`) nothing is reassociated and no decay is divided
out, so any decay in (0, 1) and any chunk length is safe; only y is
returned, as in the reference.

The kernel is ``csrc/wkv_scan.cu`` (CUDA C++ for sm_90a, bound with
``ctypes``): one thread block per (b, h) walks the tokens with the state
in registers, one column a thread.  What bounds it on an H100: at the
rwkv6-1.6b prefill shape (B=8, S=512, H=32, K=V=64, bf16) a call moves
83,894,272 bytes and needs 2,726,297,600 f32 operations (:func:`work`),
so operations bound it (0.0407 ms at 67 TFLOP/s); see the CUDA source
for what the first version's design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import wkv_recurrence
from .rwkv6_chunked import _DTYPE_CODE, MAX_HEAD_DIM, check_cuda_inputs

__all__ = ["MAX_HEAD_DIM", "wkv_scan", "wkv_scan_plain", "work"]


def _check_chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of chunk={chunk}")
    return chunk


def wkv_scan_plain(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K], decays in (0, 1)
    u: torch.Tensor,   # [H, K]
    chunk: int = 64,
) -> torch.Tensor:
    """The reference's token loop in PyTorch: y ``[B, S, H, V]`` in ``v.dtype``.

    ``rwkv6_scan._wkv_kernel`` walks the chunks in order and carries the
    f32 state from one to the next unchanged, so after the chunk check
    its walk is :func:`~repro_torch.kernels.ref.wkv_recurrence` from a
    zero state, token by token in f32; y only.
    """
    _check_chunk(r.shape[1], chunk)
    return wkv_recurrence(r, k, v, w, u)[0]


def work(B: int, S: int, H: int, K: int, V: int,
         itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` one call needs: r, k, w, v read once and y
    written once in the input type, u read once in f32; 5·K·V + 3·K + 2·V
    f32 operations a token and head.  The bonus is rank one: its scalar
    ``a = sum_k r_k u_k k_k`` takes 3·K and ``a v`` plus its add 2·V; then
    ``r^T S`` takes 2·K·V and ``w (.) S + k v^T`` 3·K·V."""
    moved = (B * S * H * (3 * K + 2 * V) * itemsize   # r, k, w, v in; y out
             + H * K * 4)                              # u in
    return moved, B * S * H * (5 * K * V + 3 * K + 2 * V)


def _lib() -> ctypes.CDLL:
    lib = build.library("wkv_scan")
    fn = lib.wkv_scan_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def wkv_scan(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K], decays in (0, 1)
    u: torch.Tensor,   # [H, K]
    chunk: int = 64,
) -> torch.Tensor:
    """Exact WKV from a zero state: y ``[B, S, H, V]`` in ``v.dtype``.

    ``chunk = min(chunk, S)`` must divide S, as in the reference.  On
    CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`wkv_scan_plain`.  ``wkv_scan.launches`` counts kernel
    launches.
    """
    if r.device.type == "cpu":
        return wkv_scan_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_scan runs on cuda or cpu, not {r.device}")
    check_cuda_inputs("wkv_scan", r, k, v, w, u)
    B, S, H, K = r.shape
    V = v.shape[-1]
    T = _check_chunk(S, chunk)
    y = torch.empty((B, S, H, V), dtype=v.dtype, device=r.device)
    u32 = u.to(torch.float32).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(0) for x in (r, k, v, w)),
        *(x.stride(1) for x in (r, k, v, w)),
        *(x.stride(2) for x in (r, k, v, w)))
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv_scan_fwd(
            _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u32.data_ptr(), y.data_ptr(), B, S, H, K, V, T,
            strides, stream)
    if err:
        raise RuntimeError(f"wkv_scan kernel launch failed: CUDA error {err}")
    wkv_scan.launches += 1
    return y


wkv_scan.launches = 0
