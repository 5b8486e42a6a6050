"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

:func:`wkv_recurrence` is the exact token-by-token WKV recurrence.  The
RWKV6 model runs it on the decode path (one token, carried state) and on
prefill when the chunked kernel does not apply; the tests hold the chunk
kernel's plain version and the CUDA kernel to it.
:func:`ring_reduce_scatter_ref` is the reduce-scatter semantics the ring
(:mod:`repro_torch.kernels.ring_collective`) is held to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ring_reduce_scatter_ref", "wkv_chunk_ref", "wkv_recurrence"]


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
