"""The port's WKV functions against the JAX package's, on the same numpy inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_chunked import wkv_chunked_matmul as jax_wkv_chunked  # noqa: E402
from repro.models.rwkv6 import wkv_recurrence as jax_wkv_recurrence  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.ops import wkv_chunked_op  # noqa: E402
from repro_torch.kernels.rwkv6_chunked import (  # noqa: E402
    wkv_chunked_matmul,
    wkv_chunked_matmul_plain,
)

# the cases of tests/test_kernels.py::CHUNKED_CASES
CHUNKED_CASES = [
    # (B, S, H, K, V, chunk, w_lo, w_hi)
    (2, 64, 2, 8, 8, 16, 0.5, 0.999),
    (1, 128, 4, 16, 16, 16, 0.3, 0.99),
    (2, 32, 1, 8, 16, 8, 0.7, 0.95),
    (1, 64, 2, 8, 8, 32, 0.9, 0.999),
    (1, 64, 2, 8, 8, 16, 0.05, 0.5),   # strong decay (range bound check)
]
# chunked matmul form vs the token recurrence: the same tolerance as
# tests/test_kernels.py (f32, the chunk form reassociates the sums)
ATOL, RTOL = 5e-4, 5e-3


def _inputs(case, seed=0):
    B, S, H, K, V, _chunk, wlo, whi = case
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((B, S, H, K)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, H, K)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, H, V)) * 0.5).astype(np.float32)
    w = rng.uniform(wlo, whi, (B, S, H, K)).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_plain_chunked_matches_jax_kernel(case):
    """The plain chunk function == JAX's Pallas kernel (interpret mode)."""
    chunk = case[5]
    arrays = _inputs(case)
    expect = jax_wkv_chunked(*_j(*arrays), chunk=chunk, interpret=True)
    y, _ = wkv_chunked_matmul_plain(*_t(*arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(expect), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_plain_chunked_state_matches_jax_recurrence(case):
    """The final state the TPU kernel drops == JAX's recurrence state."""
    chunk = case[5]
    arrays = _inputs(case, seed=1)
    y_ref, s_ref = jax_wkv_recurrence(*_j(*arrays))
    y, s = wkv_chunked_matmul_plain(*_t(*arrays), chunk=chunk)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_recurrence_matches_jax(with_state):
    case = (2, 12, 3, 8, 16, 4, 0.3, 0.99)
    r, k, v, w, u = _inputs(case, seed=2)
    state = None
    if with_state:
        state = np.random.default_rng(3).standard_normal((2, 3, 8, 16)).astype(np.float32)
    y_ref, s_ref = jax_wkv_recurrence(*_j(r, k, v, w, u),
                                      None if state is None else jnp.asarray(state))
    y, s = ref.wkv_recurrence(*_t(r, k, v, w, u),
                              None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    arrays = _t(*_inputs(CHUNKED_CASES[0]))
    before = wkv_chunked_matmul.launches
    y, s = wkv_chunked_op(*arrays)
    y2, s2 = wkv_chunked_matmul_plain(*arrays)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert wkv_chunked_matmul.launches == before


@pytest.mark.parametrize("S, chunk", [(64, 48), (40, 16)])
def test_chunk_bounds_raise(S, chunk):
    arrays = _t(*_inputs((1, S, 1, 8, 8, chunk, 0.5, 0.9)))
    with pytest.raises(ValueError):
        wkv_chunked_matmul(*arrays, chunk=chunk)


def test_bf16_plain_is_f32_math_on_bf16_inputs():
    """bf16 inputs: f32 arithmetic, y rounded once to bf16."""
    arrays = _t(*_inputs(CHUNKED_CASES[1], seed=4))
    bf = [a.to(torch.bfloat16) for a in arrays]
    y, s = wkv_chunked_matmul_plain(*bf)
    y32, s32 = wkv_chunked_matmul_plain(*[a.float() for a in bf])
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    torch.testing.assert_close(s, s32, atol=0, rtol=0)


def test_nvcc_command_targets_sm90a():
    cmd = build.nvcc_command("wkv_chunked", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/wkv_chunked.cu")
    assert "wkv_chunked" in build.sources()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_cuda_kernel_matches_plain(cuda_device, case, dtype):
    dt = getattr(torch, dtype)
    chunk = case[5]
    arrays = [a.to(cuda_device, dt) for a in _t(*_inputs(case, seed=5))]
    before = wkv_chunked_matmul.launches
    y, s = wkv_chunked_matmul(*arrays, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_chunked_matmul.launches == before + 1
    y_p, s_p = wkv_chunked_matmul_plain(*arrays, chunk=chunk)
    # same f32 math in another summation order; bf16 y rounds once more
    atol, rtol = (ATOL, RTOL) if dt == torch.float32 else (2e-2, 1.6e-2)
    torch.testing.assert_close(y.float(), y_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(s, s_p, atol=ATOL, rtol=RTOL)
