"""Hand-written CUDA kernels, each with its plain PyTorch version.

Building a kernel (``nvcc``) happens at its first launch, never at import.
"""

from .ops import wkv_chunked_op  # noqa: F401
from .rwkv6_chunked import wkv_chunked_matmul, wkv_chunked_matmul_plain  # noqa: F401
