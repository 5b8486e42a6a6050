"""The port's exact-recurrence WKV (``wkv_scan``, ``ops.wkv_op``) against
the JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

The CUDA kernel's cases on the card are in ``tests/test_torch_wkv_cuda.py``,
which imports no JAX."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rwkv6_scan import wkv_scan as jax_wkv_scan  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import wkv_recurrence  # noqa: E402
from repro_torch.kernels.rwkv6_chunked import (  # noqa: E402
    check_cuda_inputs,
    wkv_chunked_matmul_plain,
)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    MAX_HEAD_DIM,
    wkv_scan,
    wkv_scan_plain,
    wkv_scan_schedule_plain,
    work,
)

# tests/test_kernels.py::WKV_CASES: (B, S, H, K, V, chunk, dtype)
WKV_CASES = [
    (2, 32, 2, 8, 8, 8, "float32"),
    (1, 64, 4, 16, 16, 16, "float32"),
    (2, 16, 1, 8, 16, 16, "float32"),   # K != V
    (1, 32, 2, 8, 8, 32, "float32"),    # chunk == S
    (1, 32, 2, 8, 8, 8, "bfloat16"),
]
# tests/test_kernels.py:79: bf16 y rounds to bf16 (a few ulps at |y| ~ 1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(case, seed=0):
    """f32 numpy inputs shaped as tests/test_kernels.py draws them."""
    B, S, H, K, V = case[:5]
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K)) * 0.5
    k = rng.standard_normal((B, S, H, K)) * 0.5
    v = rng.standard_normal((B, S, H, V)) * 0.5
    w = 1 / (1 + np.exp(-rng.standard_normal((B, S, H, K)))) * 0.5 + 0.45
    u = rng.standard_normal((H, K)) * 0.1
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _t(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _j(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("fn", [wkv_scan_plain, ops.wkv_op],
                         ids=["wkv_scan_plain", "ops.wkv_op"])
@pytest.mark.parametrize("case", WKV_CASES)
def test_matches_jax_kernel_and_chunk_ref(case, fn):
    """== JAX's ``wkv_scan`` (interpret mode) and ``wkv_chunk_ref``."""
    chunk, dtype = case[5], case[6]
    arrays = _inputs(case)
    got = fn(*_t(arrays, dtype), chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == case[:3] + (case[4],)
    want = jax_wkv_scan(*_j(arrays, dtype), chunk=chunk, interpret=True)
    oracle, _ = jax_ref.wkv_chunk_ref(*_j(arrays, dtype))
    tol = TOL[dtype]
    for expect in (want, oracle):
        np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", WKV_CASES[:4])
def test_agrees_with_recurrence_and_chunk_form(case):
    """== the port's ``wkv_recurrence`` (1e-4) and chunk form (its tolerance,
    tests/test_kernels.py:145-157: the matmul form divides by decays)."""
    chunk = case[5]
    arrays = _t(_inputs(case, seed=1), "float32")
    y = wkv_scan_plain(*arrays, chunk=chunk)
    y_rec, _ = wkv_recurrence(*arrays)
    torch.testing.assert_close(y, y_rec, atol=1e-4, rtol=1e-4)
    y_chk, _ = wkv_chunked_matmul_plain(*arrays, chunk=min(chunk, 16))
    torch.testing.assert_close(y, y_chk, atol=5e-4, rtol=5e-3)


def test_chunk_is_a_blocking_only_and_refusals():
    """Any chunk that divides S gives the same y (the state is carried);
    one that does not is refused, as the reference asserts."""
    case = (1, 24, 2, 8, 8, 8, "float32")
    arrays = _t(_inputs(case, seed=2), "float32")
    a = wkv_scan_plain(*arrays, chunk=4)
    for chunk in (8, 24, 64):                       # 64 -> min(64, S) = S
        torch.testing.assert_close(wkv_scan(*arrays, chunk=chunk), a,
                                   atol=0, rtol=0)
    with pytest.raises(ValueError, match="not a multiple"):
        wkv_scan(*arrays, chunk=5)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.wkv_op(*arrays, chunk=7)


def test_wrapper_counts_and_refuses_on_cuda_only():
    """CPU tensors take the plain version and launch nothing; the work
    model is the kernel's bound at the rwkv6-1.6b prefill shape."""
    before = wkv_scan.launches
    wkv_scan(*_t(_inputs(WKV_CASES[0]), "float32"), chunk=8)
    assert wkv_scan.launches == before
    assert MAX_HEAD_DIM == 64 and "wkv_scan" in build.sources()
    assert work(8, 512, 32, 64, 64, 2) == (83_894_272, 2_726_297_600)


@pytest.mark.parametrize("kernel", ["wkv_scan", "wkv_chunked"])
def test_input_checks_name_the_kernel(kernel):
    """The shared checks report the kernel they guard, and the argument at
    fault by its own name."""
    r, k, v, w, u = _t(_inputs(WKV_CASES[0]), "float16")
    with pytest.raises(TypeError, match=f"^{kernel} takes float32 or bfloat16"):
        check_cuda_inputs(kernel, r, k, v, w, u)
    r, k, v, w, u = _t(_inputs(WKV_CASES[0]), "float32")
    with pytest.raises(TypeError, match="^w is torch.bfloat16, r is torch.float32"):
        check_cuda_inputs(kernel, r, k, v, w.to(torch.bfloat16), u)


@pytest.mark.parametrize("case", WKV_CASES)
def test_schedule_walk_matches_jax_kernel_and_chunk_ref(case):
    """The kernel's own decomposition walked on the CPU (the four channel
    groups' partial sums, the rank-one bonus once a token, 16-token
    stages) == JAX's ``wkv_scan`` (interpret mode) and ``wkv_chunk_ref``."""
    chunk, dtype = case[5], case[6]
    arrays = _inputs(case, seed=3)
    got = wkv_scan_schedule_plain(*_t(arrays, dtype), chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    want = jax_wkv_scan(*_j(arrays, dtype), chunk=chunk, interpret=True)
    oracle, _ = jax_ref.wkv_chunk_ref(*_j(arrays, dtype))
    tol = TOL[dtype]
    for expect in (want, oracle):
        np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)


def test_schedule_walk_pads_channels_and_stages():
    """K = 7 (padded to a channel group), V = 40 (a partial slice of state
    columns) and S = 40 (a partial stage) == JAX's ``wkv_chunk_ref``."""
    arrays = _inputs((1, 40, 2, 7, 40), seed=4)
    got = wkv_scan_schedule_plain(*_t(arrays, "float32"), chunk=8)
    oracle, _ = jax_ref.wkv_chunk_ref(*_j(arrays, "float32"))
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TOL["float32"],
                               rtol=TOL["float32"])
