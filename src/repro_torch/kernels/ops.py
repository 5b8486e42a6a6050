"""Public wrappers for the kernels (counterpart of ``repro.kernels.ops``).

Where the JAX package picks interpret mode off the TPU, each wrapper here
picks by where its tensors lie: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from .rwkv6_chunked import wkv_chunked_matmul

__all__ = ["wkv_chunked_op"]


def wkv_chunked_op(r, k, v, w, u, chunk=16):
    """Chunked-matmul WKV from a zero state: ``(y, final_state)``.

    Unlike ``repro.kernels.ops.wkv_chunked_op`` it also returns the final
    state, which the model's prefill hands to decode.
    """
    return wkv_chunked_matmul(r, k, v, w, u, chunk=chunk)
