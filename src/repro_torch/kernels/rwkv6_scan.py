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
``ctypes``): a block owns a slice of 64 state columns of one (b, h) and
walks the tokens with the state in registers split over four channel
groups a column, the sum over k split the same four ways and the u bonus
added once a token as its rank-one term; the next stages come in by TMA
while one computes.  :func:`wkv_scan_schedule_plain` walks that decomposition on the
CPU.  What bounds it on an H100: at the rwkv6-1.6b prefill shape (B=8,
S=512, H=32, K=V=64, bf16) a call moves 83,894,272 bytes and needs
2,726,297,600 f32 operations (:func:`work`), so operations bound it
(0.0407 ms at 67 TFLOP/s); see the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import accounting, build
from .ref import wkv_recurrence
from .rwkv6_chunked import (
    _DTYPE_CODE, MAX_HEAD_DIM, SLICE_COLUMNS, _pad_channels, check_cuda_inputs)

__all__ = ["MAX_HEAD_DIM", "wkv_scan", "wkv_scan_plain",
           "wkv_scan_schedule_plain", "work"]

#: tokens the kernel stages at a time (any chunk that divides S)
STAGE = 16
#: the kernel's channel groups: the threads (warps) a state column
CHANNEL_GROUPS = 4


def channel_groups(K: int, groups: int = CHANNEL_GROUPS) -> list:
    """The channels each of a column's ``groups`` threads holds: channels
    padded to a multiple of ``4 * groups``, in float4 units q = g + groups m
    (group g is one warp's, so a warp reads one float4 for all its lanes)."""
    padded = -(-K // (4 * groups)) * (4 * groups)
    return [[4 * q + e for q in range(g, padded // 4, groups) for e in range(4)]
            for g in range(groups)]


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


def wkv_scan_schedule_plain(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K], decays in (0, 1)
    u: torch.Tensor,   # [H, K]
    chunk: int = 64,
) -> torch.Tensor:
    """The kernel's own decomposition in PyTorch, in f32: y ``[B,S,H,V]``.

    Mirrors ``wkv_scan_fwd``: the grid's slices of ``SLICE_COLUMNS`` state
    columns, stages of ``STAGE`` tokens (whatever the chunk), channels
    padded as :func:`channel_groups` pads them (r = k = w = 0), each
    column's ``sum_k r_k S_kj`` as one partial sum a channel group, group
    0's starting from the rank-one bonus ``beta_t v_j`` (``beta_t = sum_k
    r_k u_k k_k``, once a token), summed in group order; the state is the
    recurrence's own, token by token.  Nothing on the main path calls it.
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    _check_chunk(S, chunk)
    split = channel_groups(K)
    padded = -(-K // (4 * CHANNEL_GROUPS)) * (4 * CHANNEL_GROUPS)
    rf, kf, wf = (_pad_channels(x.float(), padded, 0.0) for x in (r, k, w))
    vf, uf = v.float(), u.float()
    beta = (r.float() * uf * k.float()).sum(-1, keepdim=True)      # [B,S,H,1]
    y = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    for v0 in range(0, V, SLICE_COLUMNS):
        cols = slice(v0, min(v0 + SLICE_COLUMNS, V))
        state = torch.zeros((B, H, rf.shape[-1], cols.stop - v0),
                            dtype=torch.float32, device=r.device)
        for s0 in range(0, S, STAGE):
            for t in range(s0, min(s0 + STAGE, S)):
                vt = vf[:, t, :, None, cols]                       # [B,H,1,Vs]
                parts = [(rf[:, t, :, g, None] * state[:, :, g]).sum(-2)
                         for g in split]
                parts[0] = beta[:, t] * vt[:, :, 0] + parts[0]
                y[:, t, :, cols] = sum(parts[1:], parts[0])
                state = wf[:, t, :, :, None] * state + kf[:, t, :, :, None] * vt
    return y.to(v.dtype)


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
    runs :func:`wkv_scan_plain`; on meta tensors it launches nothing
    (:mod:`.accounting` tallies :func:`work` there and at each launch).  ``wkv_scan.launches`` counts kernel
    launches.
    """
    if r.device.type == "cpu":
        return wkv_scan_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type == "meta":
        # the dry run: the kernel's work and empty outputs, no launch
        check_cuda_inputs("wkv_scan", r, k, v, w, u)
        B, S, H, K = r.shape
        V = v.shape[-1]
        _check_chunk(S, chunk)
        accounting.record("wkv_scan", lambda: work(
            B, S, H, K, V, r.element_size())[::-1])
        return v.new_empty((B, S, H, V))
    if r.device.type != "cuda":
        raise ValueError(f"wkv_scan runs on cuda or cpu (and stands in on "
                         f"meta), not {r.device}")
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
    accounting.record("wkv_scan", lambda: work(
        B, S, H, K, V, r.element_size())[::-1])
    return y


wkv_scan.launches = 0
