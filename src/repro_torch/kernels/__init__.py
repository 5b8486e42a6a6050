"""Hand-written CUDA kernels, each with its plain PyTorch version.

Building a kernel (``nvcc``) happens at its first launch, never at import.
"""

# the wrapper is ``flash_attention.flash_attention``: the package keeps the
# module's name for the module
from .flash_attention import flash_attention_plain  # noqa: F401
from .ops import attention_op, fused_add, wkv_chunked_op, wkv_op  # noqa: F401
from .ring_collective import (  # noqa: F401
    fused_add_plain,
    remote_ring_reduce_scatter,
    remote_ring_reduce_scatter_plain,
    ring_all_reduce,
    ring_reduce_scatter,
)
from .rwkv6_chunked import wkv_chunked_matmul, wkv_chunked_matmul_plain  # noqa: F401
from .rwkv6_scan import wkv_scan, wkv_scan_plain  # noqa: F401
