"""RWKV6 WKV in chunked matmul form: the CUDA kernel and its plain version.

Replaces the TPU kernel ``_wkv_chunk_kernel`` / ``wkv_chunked_matmul`` of
``repro/kernels/rwkv6_chunked.py``.  Per chunk of T tokens, with
A_t = prod_{s<=t} w_s, r~_t = r_t * A_{t-1} and k~_s = k_s / A_s:

    y_t = r~_t S_0 + sum_{s<t} (r~_t . k~_s) v_s + (r_t . (u*k_t)) v_t
    S_T = A_T (.) S_0 + (k~ A_T)^T V

The kernel is ``csrc/wkv_chunked.cu`` (CUDA C++ for sm_90a, bound with
``ctypes``): one thread block per (b, h) walks the chunks in order with the
f32 state in shared memory.  Unlike the TPU kernel it also returns the
final state, so a prefill through it hands decode the real WKV state.

What bounds it on an H100: at the prefill shape of the serving path
(B=8, S=512, H=32, K=V=64, bf16) a call moves ~88 MB and does ~2.4 GFLOP
of f32 arithmetic; see the note in the CUDA source for what the design
does about it.

Numerics: k~ = k / A_s grows like w_min^-T inside a chunk, so chunks are
kept short (T <= 32; T = 16 is safe for decays w >= 1e-2).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

__all__ = ["MAX_CHUNK", "wkv_chunked_matmul", "wkv_chunked_matmul_plain"]

#: the k~ range bound (see module docstring)
MAX_CHUNK = 32
#: the kernel's shared-memory tiles bound the head widths
MAX_HEAD_DIM = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk={chunk} > {MAX_CHUNK}: k~ = k/A grows like "
                         f"w^-chunk; keep chunks short")
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of chunk={chunk}")
    return chunk


def wkv_chunked_matmul_plain(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K], decays in (0, 1)
    u: torch.Tensor,   # [H, K]
    chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same chunked matmul math in PyTorch, one chunk at a time.

    Returns ``(y [B,S,H,V] in v.dtype, S_T [B,H,K,V] f32)``.
    """
    B, S, H, K = r.shape
    T = _check_chunk(S, chunk)

    def heads_first(x):                                  # [B, H, S, *] f32
        return x.permute(0, 2, 1, 3).float()

    rf, kf, vf, wf = (heads_first(x) for x in (r, k, v, w))
    uf = u.float()[None, :, None, :]                     # [1, H, 1, K]
    state = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    strict = torch.ones((T, T), dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for c0 in range(0, S, T):
        rc, kc, vc, wc = (x[:, :, c0:c0 + T] for x in (rf, kf, vf, wf))
        log_w = torch.log(wc)
        la = torch.cumsum(log_w, dim=2)                  # log A_t
        r_t = rc * torch.exp(la - log_w)                 # r~ = r A_{t-1}
        k_t = kc * torch.exp(-la)                        # k~ = k / A_t
        qk = torch.where(strict, r_t @ k_t.transpose(-1, -2), 0.0)
        bonus = (rc * uf * kc).sum(-1, keepdim=True) * vc
        ys.append(r_t @ state + qk @ vc + bonus)
        a_T = torch.exp(la[:, :, -1])                    # [B, H, K]
        state = a_T[..., None] * state + (k_t * a_T[:, :, None]).transpose(-1, -2) @ vc
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return y, state


def work(B: int, S: int, H: int, K: int, V: int, chunk: int,
         itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` one call needs: each input read once and each
    output written once (``u`` in f32); the chunk form's operations, with
    a multiply-add counted as 2 and each elementwise step as 1."""
    T = min(chunk, S)
    moved = (B * S * H * (3 * K + 2 * V) * itemsize   # r, k, w, v in; y out
             + H * K * 4 + B * H * K * V * 4)          # u in; S_T out
    per_chunk = (4 * T * K * V                         # r~ S_0 and the S_T product
                 + T * (T - 1) * (K + V)               # strict-lower r~ k~^T, then @ V
                 + 8 * T * K                           # decay, r~, k~, bonus dot, k~ A_T
                 + 3 * T * V + 2 * K * V)              # bonus v, sums, A_T S_0
    return moved, B * H * (S // T) * per_chunk


def _lib() -> ctypes.CDLL:
    lib = build.library("wkv_chunked")
    fn = lib.wkv_chunked_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(r, k, v, w, u) -> None:
    dev = r.device
    for name, x in (("k", k), ("v", v), ("w", w), ("u", u)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, r on {dev}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv_chunked takes float32 or bfloat16, not {r.dtype}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.dtype != r.dtype:
            raise TypeError(f"{name} is {x.dtype}, r is {r.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, w must share one [B,S,H,K] shape: "
                         f"{tuple(r.shape)} {tuple(k.shape)} {tuple(w.shape)}")
    B, S, H, K = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v must be [B,S,H,V] = [{B},{S},{H},V], got {tuple(v.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be [H,K] = [{H},{K}], got {tuple(u.shape)}")
    if K > MAX_HEAD_DIM or v.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes K, V <= {MAX_HEAD_DIM}; "
                         f"got K={K}, V={v.shape[-1]}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")


def wkv_chunked_matmul(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K], decays in (0, 1)
    u: torch.Tensor,   # [H, K]
    chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV from a zero state: ``(y [B,S,H,V], S_T [B,H,K,V] f32)``.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`wkv_chunked_matmul_plain`.  ``wkv_chunked_matmul.launches``
    counts kernel launches.
    """
    if r.device.type == "cpu":
        return wkv_chunked_matmul_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_chunked runs on cuda or cpu, not {r.device}")
    _check_cuda_inputs(r, k, v, w, u)
    B, S, H, K = r.shape
    V = v.shape[-1]
    T = _check_chunk(S, chunk)
    y = torch.empty((B, S, H, V), dtype=v.dtype, device=r.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    u32 = u.to(torch.float32).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(0) for x in (r, k, v, w)),
        *(x.stride(1) for x in (r, k, v, w)),
        *(x.stride(2) for x in (r, k, v, w)))
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv_chunked_fwd(
            _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u32.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, S, H, K, V, T, strides, stream)
    if err:
        raise RuntimeError(f"wkv_chunked kernel launch failed: CUDA error {err}")
    wkv_chunked_matmul.launches += 1
    return y, state


wkv_chunked_matmul.launches = 0
