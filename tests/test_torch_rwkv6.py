"""The port's RWKV6 model against the JAX package's, on the same weights and tokens."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

B, S = 2, 32
TOL = dict(atol=1e-4, rtol=1e-4)     # f32, same math in another op order


def _cfg(impl):
    return dataclasses.replace(get_config("rwkv6-1.6b").smoke(), wkv_impl=impl)


def _jax_cfg(impl):
    return dataclasses.replace(jax_get_config("rwkv6-1.6b").smoke(), wkv_impl=impl)


@pytest.fixture(scope="module")
def weights():
    """JAX init (smoke, f32) as numpy, with a nonzero bonus ``u`` so the
    bonus term is exercised."""
    params = jax_get_model(_jax_cfg("xla")).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    u = tree["blocks"]["time_mix"]["u"]
    tree["blocks"]["time_mix"]["u"] = (rng.standard_normal(u.shape) * 0.3).astype(u.dtype)
    return tree


@pytest.fixture(scope="module")
def tokens():
    cfg = _cfg("xla")
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jax(impl, tree):
    m = jax_get_model(_jax_cfg(impl))
    return m, jax.tree.map(jnp.asarray, tree)


def _torch(impl, tree):
    m = get_model(_cfg(impl), device="cpu")
    return m, params_from_jax(tree, m)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32), **tol)


def test_forward_matches_jax_xla(weights, tokens):
    jm, jp = _jax("xla", weights)
    tm, tp = _torch("xla", weights)
    expect, _ = jm.forward(jp, jnp.asarray(tokens))
    got, _ = tm.forward(tp, torch.from_numpy(tokens).long())
    _close(got.numpy(), expect, **TOL)


def test_kernel_forward_matches_jax_kernel_forward(weights, tokens):
    """Kernel paths on both sides (JAX: Pallas interpret; port: plain
    chunk function on the CPU); the tolerance of test_perf_opts.py."""
    jm, jp = _jax("kernel", weights)
    tm, tp = _torch("kernel", weights)
    expect, _ = jm.forward(jp, jnp.asarray(tokens))
    got, _ = tm.forward(tp, torch.from_numpy(tokens).long())
    _close(got.numpy(), expect, atol=2e-3, rtol=2e-2)


def test_kernel_prefill_and_decode_match_jax_exact_recurrence(weights, tokens):
    """The port's kernel-path prefill hands decode the real WKV state, so
    prefill + three decode steps equal JAX's exact-recurrence (xla) path."""
    jm, jp = _jax("xla", weights)
    tm, tp = _torch("kernel", weights)
    jl, jc = jm.prefill(jp, jnp.asarray(tokens))
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens).long())
    _close(tl.numpy(), jl, **TOL)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        _close(tc[name].numpy(), jc[name], **TOL)
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(cur), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(cur).long(), tc)
        _close(tl.numpy(), jl, **TOL)
        for name in jc:
            _close(tc[name].numpy(), jc[name], **TOL)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_reference_kernel_prefill_drops_the_state(weights, tokens):
    """Pins the reference quirk the port does not copy: JAX's kernel-path
    prefill caches a zero WKV state (models/rwkv6.py, the kernel branch)."""
    jm, jp = _jax("kernel", weights)
    tm, tp = _torch("kernel", weights)
    _, jc = jm.prefill(jp, jnp.asarray(tokens))
    _, tc = tm.prefill(tp, torch.from_numpy(tokens).long())
    assert float(jnp.abs(jc["wkv"]).max()) == 0.0
    assert float(tc["wkv"].abs().max()) > 1.0


def test_init_cache_matches_jax():
    jc = jax_get_model(_jax_cfg("xla")).init_cache(3, 64)
    tc = get_model(_cfg("xla"), device="cpu").init_cache(3, 64)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)


def test_init_tree_matches_jax_tree(weights):
    """The port's own init builds the same names, shapes and dtypes."""
    m = get_model(_cfg("xla"), device="cpu")
    mine = m.init(torch.Generator().manual_seed(0))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(weights)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert set(flat_j) == set(flat_t)
    for path, a in flat_j.items():
        t = flat_t[path]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
    np.testing.assert_array_equal(mine["blocks"]["time_mix"]["w0"].numpy(),
                                  np.asarray(weights["blocks"]["time_mix"]["w0"]))


def test_params_from_jax_checks_names(weights):
    m = get_model(_cfg("xla"), device="cpu")
    bad = jax.tree.map(lambda a: a, weights)
    del bad["blocks"]["channel_mix"]["wr"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(bad, m)
    bad = jax.tree.map(lambda a: a, weights)
    bad["blocks"]["time_mix"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax(bad, m)
    bad = jax.tree.map(lambda a: a, weights)
    bad["lm_head"] = bad["lm_head"][:, :8]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)), dtype)
    w = jnp.asarray(1.0 + 0.1 * rng.standard_normal(64), dtype)
    expect = np.asarray(jax_rms_norm(x, w, 1e-5), np.float32)
    got = rms_norm(tensor_from_numpy(np.asarray(x)), tensor_from_numpy(np.asarray(w)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the two frameworks may round the two products at other places
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=0, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), expect, **tol)


def test_bf16_tree_converts_bit_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_loss_and_grads_match_jax(weights, tokens):
    """``loss`` and every parameter's gradient (through the exact
    recurrence, checkpointed a block) against ``jax.grad`` of the
    reference's ``loss``; f32, atol/rtol 5e-5 on the loss, 1e-4 on the
    gradients."""
    jm, jp = _jax("xla", weights)
    tm, tp = _torch("xla", weights)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    _close(loss.detach().numpy(), jloss, atol=5e-5, rtol=5e-5)
    want = jax.tree_util.tree_leaves(jgrads)
    got = [t.grad for t in tree_leaves(params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_kernel_path_refuses_a_gradient(weights, tokens):
    """The WKV kernels have no backward: with parameters that need a
    gradient the kernel path raises; without, it runs."""
    tm, tp = _torch("kernel", weights)
    toks = torch.from_numpy(tokens).long()
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tm.loss(params, {"tokens": toks, "labels": toks})
    with torch.no_grad():
        feats, _ = tm.forward(params, toks, return_features=True)
    assert tuple(feats.shape) == (B, S, tm.cfg.d_model)
