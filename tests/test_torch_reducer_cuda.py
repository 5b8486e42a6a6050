"""The reducer kernels on the card: the peer ring's FIFO protocol and
``fused_add`` at the edges of their designs.

Each case is exact against the kernel's plain version.  It needs no JAX,
so it runs on a machine with an NVIDIA GPU and no JAX::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_reducer_cuda.py

Without a card every case skips.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import ring_collective as rc  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gen(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _ring_exact(x, perm):
    before = rc.remote_ring_reduce_scatter.launches
    got = rc.remote_ring_reduce_scatter(x, perm)
    torch.cuda.synchronize()
    assert rc.remote_ring_reduce_scatter.launches == before + 1
    assert rc.ring_status(x.device) == 0
    assert torch.equal(got, rc.remote_ring_reduce_scatter_plain(x, perm))
    assert torch.equal(got, rc.ring_reduce_scatter(x, perm))
    return got


@pytest.mark.cuda
def test_cuda_peer_ring_twenty_launches_of_mixed_shapes(cuda_device):
    """Launches of other L (so other block and tile counts) on other
    orders and dtypes, one after another on the same counters and FIFO."""
    rng = np.random.default_rng(0)
    gen = _gen(cuda_device, 0)
    tile = rc.ring_fifo(8, cuda_device)["tile_bytes"] // 2     # bf16 elements
    widths = [7, 1031, tile - 8, tile + 8, 3 * tile + 24, 8 * 4099, 131072]
    for k in range(20):
        width = widths[k % len(widths)]
        perm = [int(p) for p in rng.permutation(8)]
        dt = (torch.bfloat16, torch.float32)[k % 2]
        x = torch.randn((8, 8 * width), generator=gen, device=cuda_device).to(dt)
        _ring_exact(x, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_peer_ring_two_ranks(cuda_device, dtype):
    """n = 2: one round, no FIFO slot."""
    gen = _gen(cuda_device, 2)
    for width in (1, 7, 4096, 123457):
        for perm in ([0, 1], [1, 0]):
            x = torch.randn((2, 2 * width), generator=gen,
                            device=cuda_device).to(getattr(torch, dtype))
            _ring_exact(x, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4, 8])
def test_cuda_peer_ring_chunks_below_a_tile_and_ragged(cuda_device, n):
    """Chunks smaller than one tile and chunks that are not a multiple of
    a tile, in 16-byte units and in scalars."""
    gen = _gen(cuda_device, n)
    tile = rc.ring_fifo(n, cuda_device)["tile_bytes"] // 2
    rng = np.random.default_rng(n)
    for width in (8, 24, tile - 8, tile + 8, 5 * tile + 40, 5 * tile + 3):
        perm = [int(p) for p in rng.permutation(n)]
        x = torch.randn((n, n * width), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        _ring_exact(x, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 8])
def test_cuda_peer_ring_bf16_scalar_path(cuda_device, n):
    """Rows one element off a 16-byte boundary, and an odd chunk length:
    the scalar variant."""
    gen = _gen(cuda_device, 10 + n)
    perm = [int(p) for p in np.random.default_rng(n).permutation(n)]
    for width in (1000, 4099, 40001):
        buf = torch.randn(n * n * width + 1, generator=gen,
                          device=cuda_device).to(torch.bfloat16)
        _ring_exact(buf[1:].view(n, n * width), perm)
        x = torch.randn((n, n * (width + 1)), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        _ring_exact(x, perm)


@pytest.mark.cuda
def test_cuda_peer_ring_graph_replays(cuda_device):
    """A captured launch replays exact on fresh data three times: the
    epochs come from the device, and the FIFO is the cached one."""
    gen = _gen(cuda_device, 3)
    perm = [0, 7, 3, 5, 2, 4, 1, 6]
    x = torch.randn((8, 8 * 40001), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    _ring_exact(x, perm)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rc.remote_ring_reduce_scatter(x, perm)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        assert rc.ring_status(cuda_device) == 0
        assert torch.equal(out, rc.remote_ring_reduce_scatter_plain(x, perm))


@pytest.mark.cuda
def test_cuda_peer_ring_fifo_is_bounded(cuda_device):
    """The FIFO does not grow with L and stays within 16 MiB at n = 8."""
    info = rc.ring_fifo(8, cuda_device)
    assert info["bytes"] == 8 * info["blocks_per_rank"] * info["slots"] * \
        info["tile_bytes"] <= rc.RING_FIFO_BUDGET
    _ring_exact(torch.randn((8, 8 * (1 << 20)), device=cuda_device)
                .to(torch.bfloat16), list(range(8)))
    assert rc.ring_fifo(8, cuda_device) == info


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_add_at_offsets(cuda_device, dtype):
    """a, b and out at element offsets 0-7 into their buffers, the same
    (a scalar head, a 16-byte body, a scalar tail) and different (scalars
    throughout), below one tile and across many, in and out of place."""
    dt = getattr(torch, dtype)
    gen = _gen(cuda_device, 5)
    rng = np.random.default_rng(5)
    same = [(o, o, o) for o in range(8)]
    mixed = [tuple(int(v) for v in rng.integers(0, 8, 3)) for _ in range(16)]
    for n in (5, 1000, 3 * 8192 + 11, 1 << 20):
        abuf = torch.randn(n + 8, generator=gen, device=cuda_device).to(dt)
        bbuf = torch.randn(n + 8, generator=gen, device=cuda_device).to(dt)
        for oa, ob, oo in same + mixed:
            a, b = abuf[oa:oa + n], bbuf[ob:ob + n]
            want = rc.fused_add_plain(a, b)
            out = torch.full((n + 8,), 7.0, device=cuda_device, dtype=dt)
            got = rc.fused_add(a, b, out=out[oo:oo + n])
            acc = abuf.clone()
            rc.fused_add(acc[oa:oa + n], b, out=acc[oa:oa + n])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, oa, ob, oo)
            assert torch.equal(acc[oa:oa + n], want), (n, oa, ob, oo)
            # nothing outside the view is touched
            assert bool((out[:oo] == 7).all()) and bool((out[oo + n:] == 7).all())
            assert torch.equal(acc[:oa], abuf[:oa])
            assert torch.equal(acc[oa + n:], abuf[oa + n:])
