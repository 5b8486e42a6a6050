"""Public wrappers for the kernels (counterpart of ``repro.kernels.ops``).

Where the JAX package picks interpret mode off the TPU, each wrapper here
picks by where its tensors lie: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .ring_collective import fused_add
from .rwkv6_chunked import wkv_chunked_matmul
from .rwkv6_scan import wkv_scan

__all__ = ["attention_op", "fused_add", "wkv_chunked_op", "wkv_op"]


def attention_op(q, k, v, causal=True, window=0, block_q=128, block_k=128):
    """Flash attention forward: the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors (``repro.kernels.ops.attention_op``)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)


def wkv_chunked_op(r, k, v, w, u, chunk=16):
    """Chunked-matmul WKV from a zero state: ``(y, final_state)``.

    Unlike ``repro.kernels.ops.wkv_chunked_op`` it also returns the final
    state, which the model's prefill hands to decode.
    """
    return wkv_chunked_matmul(r, k, v, w, u, chunk=chunk)


def wkv_op(r, k, v, w, u, chunk=64):
    """The exact WKV recurrence from a zero state: y ``[B, S, H, V]``
    (``repro.kernels.ops.wkv_op``): the scan kernel on CUDA tensors, its
    plain version on CPU tensors."""
    return wkv_scan(r, k, v, w, u, chunk=chunk)
