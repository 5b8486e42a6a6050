"""The port's flash attention against the JAX package's, on the same inputs.

On the CPU the port's ``flash_attention`` runs its plain version; it is
held to JAX's Pallas kernel in interpret mode and to ``attention_ref`` at
the reference's own tolerance (``tests/test_kernels.py``: f32 2e-5, bf16
2e-2).  The ``cuda`` cases hold the CUDA kernel to the plain version.
"""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models.layers import _sdpa  # noqa: E402

# tests/test_kernels.py:21-29
FLASH_CASES = [
    # (B, H, KV, S, hd, bq, bk, causal, window, dtype)
    (2, 4, 2, 64, 16, 16, 16, True, 0, "float32"),
    (1, 8, 8, 128, 32, 32, 64, True, 0, "float32"),
    (2, 4, 1, 64, 16, 32, 16, False, 0, "float32"),   # MQA, full attn
    (1, 4, 2, 128, 16, 32, 32, True, 32, "float32"),  # window: leading tiles masked
    (1, 2, 2, 64, 16, 64, 64, True, 0, "float32"),    # single block
    (1, 2, 2, 64, 16, 16, 16, True, 0, "bfloat16"),
    (2, 6, 3, 96, 8, 32, 32, True, 0, "float32"),     # non-pow2 heads
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, H, KV, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, S, hd)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


@pytest.fixture(scope="module")
def jax_outputs():
    """Per case: (JAX interpret-mode kernel, JAX ``attention_ref``) as f32."""
    out = {}
    for case in FLASH_CASES:
        B, H, KV, S, hd, bq, bk, causal, window, dt = case
        q, k, v = _jax(_inputs(B, H, KV, S, hd), dt)
        kern = jax_flash(q, k, v, causal=causal, window=window, block_q=bq,
                         block_k=bk, interpret=True)
        ref = jax_ref.attention_ref(q, k, v, causal=causal, window=window)
        out[case] = (np.asarray(kern, np.float32), np.asarray(ref, np.float32))
    return out


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_port_flash_matches_jax_kernel_and_ref(case, jax_outputs):
    B, H, KV, S, hd, bq, bk, causal, window, dt = case
    q, k, v = _torch(_inputs(B, H, KV, S, hd), dt)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=bq, block_k=bk)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, S, hd)
    kern, ref = jax_outputs[case]
    tol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), kern, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_port_attention_ref_matches_jax_ref(case, jax_outputs):
    B, H, KV, S, hd, _, _, causal, window, dt = case
    q, k, v = _torch(_inputs(B, H, KV, S, hd), dt)
    got = attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), jax_outputs[case][1],
                               atol=tol, rtol=tol)


def test_flash_matches_model_sdpa():
    """Flash vs the port's plain grouped attention (tests/test_kernels.py:42-52)."""
    q, k, v = _torch(_inputs(2, 4, 2, 64, 16, seed=1), "float32")
    a = fa.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    b = _sdpa(q, k, v, causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_attention_op_is_the_flash_wrapper():
    q, k, v = _torch(_inputs(1, 4, 2, 32, 16, seed=2), "float32")
    assert torch.equal(ops.attention_op(q, k, v, window=8),
                       fa.flash_attention(q, k, v, window=8))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = _torch(_inputs(1, 2, 1, 16, 8, seed=3), "float32")
    before = fa.flash_attention.launches
    by_kernel = dict(fa.flash_attention.kernel_launches)
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v))
    assert fa.flash_attention.launches == before
    assert fa.flash_attention.kernel_launches == by_kernel
    assert set(by_kernel) == set(fa.KERNELS) == {
        "flash_fwd_fma", "flash_fwd_mma", "flash_fwd_wgmma"}


def test_rows_aligned_takes_the_models_views_and_refuses_the_rest():
    """What the kernels read in place: the model's q/k/v (transposed views
    of ``[B, S, heads, hd]``) and size-1 dimensions of any stride; a
    broadcast (stride 0) or a row off 16 bytes is copied first."""
    x = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)
    assert fa._rows_aligned(x.transpose(1, 2))
    assert fa._rows_aligned(x[:1].transpose(1, 2))
    assert fa._rows_aligned(torch.zeros((1, 1, 5, 64)).as_strided(
        (1, 1, 5, 64), (7, 3, 64, 1)))
    assert not fa._rows_aligned(x[:, :, :1].expand(2, 64, 4, 128).transpose(1, 2))
    assert not fa._rows_aligned(x[..., 1:65].transpose(1, 2))
    assert not fa._rows_aligned(x.transpose(-1, -2))


@pytest.mark.parametrize("shapes,match", [
    (((1, 3, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8)), "multiple of n_kv_heads"),
    (((1, 2, 16, 8), (1, 2, 8, 8), (1, 2, 8, 8)), r"\[B, KV, S, hd\]"),
    (((1, 2, 192, 8), (1, 1, 192, 8), (1, 1, 192, 8)), "not a multiple of block"),
])
def test_argument_checks_follow_the_reference(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


def test_other_devices_raise():
    """A device other than cuda and cpu raises; meta is the dry run's
    stand-in (``test_torch_dryrun.py``), so a tensor that reports another
    device type stands in for one."""
    class Elsewhere:
        device = torch.device("xpu")

    q = Elsewhere()
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5),
                                           (False, 5)])
def test_work_counts_the_unmasked_pairs(causal, window):
    S = 24
    pos = np.arange(S)
    rel = pos[:, None] - pos[None, :]
    mask = rel >= 0 if causal else np.ones_like(rel, dtype=bool)
    if window:
        mask = mask & (rel < window)
    flops, moved = fa.work(2, 4, 2, S, 16, causal, window, itemsize=4)
    assert flops == 4 * 16 * 2 * 4 * int(mask.sum())
    assert moved == (2 * 2 * 4 * S * 16 + 2 * 2 * 2 * S * 16) * 4


def test_work_at_the_glm4_serving_shape():
    flops, moved = fa.work(8, 32, 2, 2048, 128, True, 0)
    assert flops == 4 * 128 * 8 * 32 * 2048 * 2049 // 2    # 2.75e11
    assert moved == 285_212_672


# ---------------------------------------------------------------------------
# the CUDA kernel (skipped without a GPU)
# ---------------------------------------------------------------------------

#: kernel vs plain on the card: the same f32 math summed in another order
#: (f32); bf16 also rounds each probability to bf16 for the P.V product
#: and the output once (about two bf16 ulps at |o| <= 4)
CUDA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 1.6e-2)}

CUDA_CASES = FLASH_CASES + [
    # ragged tails (S not a multiple of the kernel's tiles), every head
    # width of the repo's configs in bf16 (the tensor-core path), GQA 16
    (1, 4, 2, 130, 64, 130, 130, True, 0, "bfloat16"),
    (2, 2, 1, 17, 8, 17, 17, True, 0, "bfloat16"),
    (1, 32, 2, 256, 128, 128, 128, True, 0, "bfloat16"),
    (1, 32, 2, 256, 128, 128, 128, True, 0, "float32"),
    (1, 4, 2, 256, 256, 128, 128, True, 100, "bfloat16"),
    (1, 4, 1, 192, 32, 64, 64, False, 70, "bfloat16"),
    (2, 14, 2, 128, 64, 128, 128, False, 0, "float32"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_cuda_kernel_matches_plain(case, cuda):
    B, H, KV, S, hd, bq, bk, causal, window, dt = case
    q, k, v = _torch(_inputs(B, H, KV, S, hd), dt, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    block_q=bq, block_k=bk)
    atol, rtol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views(cuda):
    """v as ``_qkv`` makes it: a transposed view of a [B, S, KV*hd] matmul."""
    q, k, v = _torch(_inputs(2, 8, 2, 64, 64, seed=4), "bfloat16", cuda)
    v_view = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert not v_view.is_contiguous()
    got = fa.flash_attention(q, k, v_view, block_q=64, block_k=64)
    want = fa.flash_attention_plain(q, k, v, block_q=64, block_k=64)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1.6e-2)


#: bf16 at head widths 64 and 128, the wgmma kernel's: S below its 128-row
#: tile, ragged S, GQA 16, a window of 70 and no mask
WGMMA_CASES = [c for hd in (64, 128) for c in (
    (1, 2, 1, 64, hd, 64, 64, True, 0),
    (1, 4, 2, 130, hd, 130, 130, True, 0),
    (2, 2, 1, 200, hd, 200, 200, True, 0),
    (1, 32, 2, 256, hd, 128, 128, True, 0),
    (1, 4, 2, 256, hd, 128, 128, True, 70),
    (2, 4, 2, 256, hd, 128, 128, False, 0),
)]


def _wgmma_check(q, k, v, want, **kw):
    """One launch of ``flash_fwd_wgmma`` held to ``want``, and a second one
    bit for bit to the first."""
    before = fa.flash_attention.kernel_launches["flash_fwd_wgmma"]
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.kernel_launches["flash_fwd_wgmma"] == before + 2
    assert torch.equal(got, again)
    atol, rtol = CUDA_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_cuda_wgmma_kernel_matches_plain(case, cuda):
    B, H, KV, S, hd, bq, bk, causal, window = case
    q, k, v = _torch(_inputs(B, H, KV, S, hd), "bfloat16", cuda)
    kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
    _wgmma_check(q, k, v, fa.flash_attention_plain(q, k, v, **kw), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_wgmma_kernel_reads_the_models_views(hd, cuda):
    """q, k and v as ``_qkv`` makes them: ``[B, S, heads, hd]`` transposed,
    rows ``heads * hd`` elements apart."""
    q, k, v = _torch(_inputs(2, 8, 2, 192, hd, seed=6), "bfloat16", cuda)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not any(x.is_contiguous() for x in views)
    _wgmma_check(*views, fa.flash_attention_plain(q, k, v, block_q=64,
                                                  block_k=64),
                 block_q=64, block_k=64)


@pytest.mark.cuda
def test_cuda_sm_scale_is_passed_through(cuda):
    q, k, v = _torch(_inputs(1, 2, 2, 32, 16, seed=5), "float32", cuda)
    got = fa.flash_attention(q, k, v, sm_scale=0.5 / math.sqrt(16))
    want = fa.flash_attention_plain(q, k, v, sm_scale=0.5 / math.sqrt(16))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
