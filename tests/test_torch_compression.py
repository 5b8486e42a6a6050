"""The port's gradient compression against the reference's on the same inputs.

``compress_grads``, ``decompress_grads`` and the error-feedback residual
bit for bit against ``repro.optim.compression`` on a small tree (f32 and
bf16 leaves, a zero leaf and a value at half a step, which rounds to
even);
``compressed_psum`` on an 8-rank virtual mesh against the sum of each
rank's dequantized row (each row quantized by the reference's own
``_quantize``, summed in f64: within the f32 rounding of the ring's
order, atol 1e-6 on sums of scale 1), bit for bit against its plain-``+``
run, and not the answer of one scale over the stacked tensor; the
reference's error-feedback convergence test
(``tests/test_substrate.py:71-82``) mirrored.  The group-backed
``compressed_psum`` runs in ``tests/test_torch_group.py``'s spawn.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import compression as R_c  # noqa: E402
from repro_torch.kernels import ring_collective as rc  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.optim import compression as T_c  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N = 8


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32) * 1e-3,
            "layers": [rng.standard_normal((3, 4)).astype(np.float32),
                       np.zeros((2,), np.float32)]}


def _jx(tree):
    return {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
            "layers": [jnp.asarray(a) for a in tree["layers"]]}


def _th(tree, dtype=torch.float32):
    return {"w": torch.tensor(tree["w"]).to(dtype),
            "b": torch.tensor(tree["b"]).to(dtype),
            "layers": [torch.tensor(a).to(dtype) for a in tree["layers"]]}


def _np(leaves):
    return [np.asarray(a) for a in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_and_residual_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    g, r = _tree(rng), _tree(rng)
    r = {k: (v * 1e-2 if k != "layers" else [a * 1e-2 for a in v])
         for k, v in r.items()}
    g_t = _th(g, getattr(torch, dtype))
    g_j = {k: (jnp.asarray(g_t[k].float().numpy()).astype(dtype)
               if k != "layers" else
               [jnp.asarray(a.float().numpy()).astype(dtype)
                for a in g_t[k]]) for k in g_t}
    q_j, s_j, res_j = R_c.compress_grads(g_j, _jx(r))
    q_t, s_t, res_t = T_c.compress_grads(g_t, _th(r))
    for got, want in zip(tree_leaves(q_t), _np(R_c.jax.tree.leaves(q_j))):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    for tree_t, tree_j in ((s_t, s_j), (res_t, res_j)):
        for got, want in zip(tree_leaves(tree_t), _np(R_c.jax.tree.leaves(tree_j))):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    deq_j = R_c.decompress_grads(q_j, s_j)
    for got, want in zip(tree_leaves(T_c.decompress_grads(q_t, s_t)),
                         _np(R_c.jax.tree.leaves(deq_j))):
        np.testing.assert_array_equal(got.numpy(), want)
    # half a quantization step exactly (x / scale == +-0.5): to even, 0
    half = np.float32(0.5) * (np.float32(1.0) / np.float32(127.0))
    v = np.asarray([1.0, half, -half], np.float32)
    q, _ = T_c._quantize(torch.tensor(v))
    assert q.tolist() == [127, 0, 0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(R_c._quantize(v)[0]))
    zeros = T_c.error_feedback_update(g_t)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in tree_leaves(zeros))


def test_compressed_psum_sums_each_ranks_own_quantization():
    rng = np.random.default_rng(1)
    # ranks of very different scales: one scale over the stack would zero
    # the small ranks' contributions
    x = (rng.standard_normal((N, 100)) * np.logspace(-3, 0, N)[:, None]
         ).astype(np.float32)
    mesh = make_mesh((N,), ("data",), device="cpu")
    before = rc.fused_add.launches
    got = T_c.compressed_psum(torch.tensor(x), mesh)
    assert rc.fused_add.launches == before        # the plain version here
    plain = T_c.compressed_psum(torch.tensor(x), mesh, use_kernel_add=False)
    assert got.shape == x.shape and torch.equal(got, plain)
    # the reference's quantizer, row by row, summed in f64
    deq = [np.asarray(R_c.decompress_grads(*R_c._quantize(jnp.asarray(row))))
           for row in x]
    want = np.sum(np.asarray(deq, np.float64), axis=0)
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want, atol=1e-6, rtol=0)
    q, s = R_c._quantize(jnp.asarray(x))               # one scale for all
    one_scale = np.asarray(q, np.float64).sum(0) * float(s)
    assert np.abs(one_scale - want).max() > 1e-3


def test_compressed_psum_pads_a_width_the_ring_does_not_divide():
    x = np.random.default_rng(2).standard_normal((N, 3, 5)).astype(np.float32)
    mesh = make_mesh((N,), ("data",), device="cpu")
    got = T_c.compressed_psum(torch.tensor(x), mesh)
    deq = np.stack([T_c._dequantize(*T_c._quantize(torch.tensor(r))).numpy()
                    for r in x]).astype(np.float64)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(deq.sum(0), x.shape),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="one axis"):
        T_c.compressed_psum(torch.tensor(x),
                            make_mesh((4, 2), ("data", "model"), device="cpu"))


def test_compression_error_feedback_converges():
    """tests/test_substrate.py:71-82 on the port: with error feedback,
    repeated compression of a constant gradient delivers its full
    magnitude on average (the residual stays bounded)."""
    g = {"w": torch.tensor(np.random.default_rng(0).standard_normal(256) * 1e-3,
                           dtype=torch.float32)}
    residual = T_c.error_feedback_update(g)
    acc = torch.zeros(256)
    for _ in range(50):
        q, s, residual = T_c.compress_grads(g, residual)
        acc = acc + T_c.decompress_grads(q, s)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(), atol=1e-4)
    assert float(residual["w"].abs().max()) < 1e-3
