"""The WKV kernels on the card: ``wkv_chunked`` and ``wkv_scan`` against
their plain versions at the edges of their designs.

Each case holds y at the path's tolerance and the chunk kernel's state at
the f32 tolerance, in f32 and bf16, and launches twice for the same bits.
It needs no JAX, so it runs on a machine with an NVIDIA GPU and no JAX::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_wkv_cuda.py

Without a card every case skips.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rwkv6_chunked import (  # noqa: E402
    wkv_chunked_matmul,
    wkv_chunked_matmul_plain,
)
from repro_torch.kernels.rwkv6_scan import wkv_scan, wkv_scan_plain  # noqa: E402

# tests/test_kernels.py::CHUNKED_CASES: (B, S, H, K, V, chunk, w_lo, w_hi)
CHUNKED_CASES = [
    (2, 64, 2, 8, 8, 16, 0.5, 0.999),
    (1, 128, 4, 16, 16, 16, 0.3, 0.99),
    (2, 32, 1, 8, 16, 8, 0.7, 0.95),
    (1, 64, 2, 8, 8, 32, 0.9, 0.999),
    (1, 64, 2, 8, 8, 16, 0.05, 0.5),
]
# tests/test_kernels.py::WKV_CASES: (B, S, H, K, V, chunk, dtype)
WKV_CASES = [
    (2, 32, 2, 8, 8, 8, "float32"),
    (1, 64, 4, 16, 16, 16, "float32"),
    (2, 16, 1, 8, 16, 16, "float32"),
    (1, 32, 2, 8, 8, 32, "float32"),
    (1, 32, 2, 8, 8, 8, "bfloat16"),
]
# the edges of the designs: K and V of 8, 16, 48 and 64 (V = 40 and 48
# fill no slice of state columns), chunks 8, 16 and 32, decays at the
# 1e-2 range bound (chunks up to 16: k~ = k / A reaches w^-chunk) and at
# 0.999; S = 40 leaves the scan a partial stage
EDGE_CASES = [
    (2, 64, 2, 8, 8, 8, 0.01, 0.02),
    (1, 64, 3, 16, 48, 16, 0.01, 0.05),
    (1, 96, 2, 48, 40, 32, 0.9, 0.999),
    (2, 64, 2, 64, 64, 16, 0.3, 0.999),
    (1, 64, 2, 64, 64, 32, 0.999, 0.999),
    (1, 40, 2, 64, 48, 8, 0.01, 0.999),
]
# kernel vs plain on the same inputs: the same f32 math summed in another
# order (the chunk-form tolerance of the CPU tests); bf16 y also rounds
# once to bf16 (2 ulps relative); the state is f32 in both dtypes
TOL = {torch.float32: (5e-4, 5e-3), torch.bfloat16: (2e-2, 1.6e-2)}
STATE_TOL = TOL[torch.float32]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _chunked_inputs(case, device, dtype, seed):
    B, S, H, K, V, _chunk, lo, hi = case
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K)) * 0.5
    k = rng.standard_normal((B, S, H, K)) * 0.5
    v = rng.standard_normal((B, S, H, V)) * 0.5
    w = rng.uniform(lo, hi, (B, S, H, K))
    u = rng.standard_normal((H, K)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in (r, k, v, w, u)]


def _views(arrays, offset):
    """r, k, v, w as slices of one wider ``[B, S, H, 4K + 8]`` tensor, as the
    heads of one projection, starting ``offset`` elements in (the last
    dimension contiguous; 16-byte rows only when offset and K allow)."""
    r, k, v, w, u = arrays
    K = r.shape[-1]
    assert v.shape[-1] == K
    big = torch.zeros(r.shape[:3] + (4 * K + 8,), dtype=r.dtype, device=r.device)
    out = []
    for i, x in enumerate((r, k, v, w)):
        view = big[..., offset + i * K:offset + (i + 1) * K]
        view.copy_(x)
        out.append(view)
    return out + [u]


def _chunked_exact(arrays, chunk):
    before = wkv_chunked_matmul.launches
    y, s = wkv_chunked_matmul(*arrays, chunk=chunk)
    y2, s2 = wkv_chunked_matmul(*arrays, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_chunked_matmul.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    y_p, s_p = wkv_chunked_matmul_plain(*arrays, chunk=chunk)
    torch.testing.assert_close(y.float(), y_p.float(), atol=TOL[y.dtype][0],
                               rtol=TOL[y.dtype][1])
    torch.testing.assert_close(s, s_p, atol=STATE_TOL[0], rtol=STATE_TOL[1])
    assert y.dtype == arrays[2].dtype and s.dtype == torch.float32


def _scan_exact(arrays, chunk):
    before = wkv_scan.launches
    y = wkv_scan(*arrays, chunk=chunk)
    y2 = ops.wkv_op(*arrays, chunk=chunk)           # a second call from zero
    torch.cuda.synchronize()
    assert wkv_scan.launches == before + 2
    assert torch.equal(y, y2)
    torch.testing.assert_close(y.float(), wkv_scan_plain(*arrays, chunk=chunk).float(),
                               atol=TOL[y.dtype][0], rtol=TOL[y.dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_cuda_chunked_kernel_matches_plain(cuda_device, case, dtype):
    arrays = _chunked_inputs(case, cuda_device, getattr(torch, dtype), seed=5)
    _chunked_exact(arrays, case[5])


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES)
def test_cuda_scan_kernel_matches_plain(cuda_device, case):
    chunk, dtype = case[5], getattr(torch, case[6])
    B, S, H, K, V = case[:5]
    arrays = _chunked_inputs((B, S, H, K, V, chunk, 0.45, 0.95), cuda_device,
                             dtype, seed=5)
    _scan_exact(arrays, chunk)
    with pytest.raises(ValueError, match="K, V <="):
        big = torch.zeros((1, 8, 1, 65), device=cuda_device)
        wkv_scan(big, big, big, big, torch.zeros((1, 65), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_kernels_at_the_edges(cuda_device, case, dtype):
    """Head widths, partial column slices, chunks and decay ranges."""
    arrays = _chunked_inputs(case, cuda_device, getattr(torch, dtype), seed=7)
    _chunked_exact(arrays, case[5])
    _scan_exact(arrays, case[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 8, 1, 3])
@pytest.mark.parametrize("K", [8, 16, 64])
def test_cuda_kernels_on_strided_views(cuda_device, K, offset, dtype):
    """r, k, v, w as slices of one wider tensor: 16-byte rows (offset 0
    and 8) take the kernels' bulk copies, the others their element loads;
    both give the dense inputs' bits."""
    case = (2, 48, 3, K, K, 16, 0.3, 0.999)
    dense = _chunked_inputs(case, cuda_device, getattr(torch, dtype), seed=9)
    views = _views(dense, offset)
    _chunked_exact(views, 16)
    _scan_exact(views, 16)
    assert all(torch.equal(a, b) for a, b in zip(
        wkv_chunked_matmul(*views, chunk=16), wkv_chunked_matmul(*dense, chunk=16)))
    assert torch.equal(wkv_scan(*views, chunk=16), wkv_scan(*dense, chunk=16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_on_heads_first_views(cuda_device, dtype):
    """[B, H, S, K] tensors seen as [B, S, H, K]: other (s, h) strides."""
    case = (2, 64, 4, 64, 64, 16, 0.3, 0.999)
    dense = _chunked_inputs(case, cuda_device, getattr(torch, dtype), seed=11)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in dense[:4]]
    views.append(dense[4])
    assert views[0].stride() != dense[0].stride()
    _chunked_exact(views, 16)
    _scan_exact(views, 64)
    assert torch.equal(wkv_scan(*views, chunk=64), wkv_scan(*dense, chunk=64))


@pytest.mark.cuda
def test_cuda_chunked_kernel_refuses_what_it_never_took(cuda_device):
    """The refusals are the wrapper's, as before: chunks over 32, chunks
    that do not divide S, head widths over 64."""
    arrays = _chunked_inputs((1, 64, 1, 8, 8, 16, 0.5, 0.9), cuda_device,
                             torch.float32, seed=0)
    with pytest.raises(ValueError, match="chunk=64 > 32"):
        wkv_chunked_matmul(*arrays, chunk=64)
    with pytest.raises(ValueError, match="not a multiple"):
        wkv_chunked_matmul(*arrays, chunk=24)
    big = torch.zeros((1, 16, 1, 65), device=cuda_device)
    with pytest.raises(ValueError, match="K, V <="):
        wkv_chunked_matmul(big, big, big, big, torch.zeros((1, 65), device=cuda_device))
