"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

:func:`attention_ref` is direct f32 softmax attention, the oracle the
flash kernel (:mod:`repro_torch.kernels.flash_attention`) is held to.
:func:`wkv_recurrence` is the exact token-by-token WKV recurrence.  The
RWKV6 model runs it on the decode path (one token, carried state) and on
prefill when the chunked kernel does not apply; the tests hold the chunk
kernel's plain version and the CUDA kernel to it.
:func:`ring_reduce_scatter_ref` is the reduce-scatter semantics the ring
(:mod:`repro_torch.kernels.ring_collective`) is held to.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "ring_reduce_scatter_ref", "wkv_chunk_ref",
           "wkv_recurrence"]


def attention_ref(
    q: torch.Tensor,           # [B, H, S, hd]
    k: torch.Tensor,           # [B, KV, S, hd]
    v: torch.Tensor,           # [B, KV, S, hd]
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention in f32 with the whole ``[S, S]`` score matrix;
    masked scores are ``-1e30``, GQA maps query head h to kv head
    ``h // (H // KV)``.  The output comes back in ``q.dtype``."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, H // KV, S, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qh, k.float()) * sm_scale
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    if window:
        mask = mask & (rel < window)
    s = torch.where(mask, s, -1e30)
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def wkv_recurrence(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,   # [B, S, H, K]
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K]   decay in (0, 1), data dependent
    u: torch.Tensor,   # [H, K]         bonus for the current token
    state: Optional[torch.Tensor] = None,  # [B, H, K, V] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_t = r_t . (S_{t-1} + (u*k_t) outer v_t);  S_t = diag(w_t) S_{t-1} + k_t outer v_t.

    Arithmetic in f32; ``y`` comes back in ``v.dtype``, the state in f32.
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    if state is None:
        state = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # [B,H,K,V]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1).to(v.dtype), state


def wkv_chunk_ref(r, k, v, w, u, state=None):
    """Token-by-token WKV recurrence (identical to :func:`wkv_recurrence`)."""
    return wkv_recurrence(r, k, v, w, u, state)


def ring_reduce_scatter_ref(x: torch.Tensor, n_shards: int, axis: int = 0
                            ) -> torch.Tensor:
    """Reduce-scatter semantics oracle: sum over shards, split along axis.

    x: [n_shards, ...] stacked per-rank contributions; returns the stacked
    per-rank results [n_shards, chunk, ...].
    """
    total = x.sum(dim=0)                              # the all-reduced value
    return torch.stack(torch.chunk(total, n_shards, dim=axis))
