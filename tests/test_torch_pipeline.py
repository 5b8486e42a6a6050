"""The port's GPipe pipeline against the reference's on the same inputs.

The reference test's own case (``tests/test_system.py:143-170``): 8
stages of ``tanh(x @ w)`` on ``(4, 2, 16)`` microbatches, on the port's
8-stage virtual mesh, held to the sequential chain computed in JAX (atol
1e-4) and its gradient to ``jax.grad`` of it (atol 1e-3), the reference
test's tolerances.  The reference's own ``pipeline_forward`` and
``jax.grad`` run on the one-stage mesh a single CPU device allows,
against the port's one-stage pipeline.  A smoke ``DecoderLM``'s stacked
blocks as stages: the pipeline's output and every block gradient against
the reference's ``_block_fwd`` chained in JAX (f32 on both sides, the same
math in another order: atol 1e-5 on activations of scale 1, and 1e-5 of
each gradient's largest entry, which reaches 100 here).  The group-backed pipeline runs in
``tests/test_torch_group.py``'s spawn.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.parallel import pipeline_forward as ref_pipeline_forward  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_forward, pipeline_loss  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

N_STAGES = 8


def _tanh_case(n_stages=N_STAGES):
    """tests/test_system.py:144-145: the stage weights and microbatches."""
    ws = (np.random.default_rng(1).standard_normal((n_stages, 16, 16))
          * 0.3).astype(np.float32)
    xs = np.random.default_rng(2).standard_normal((4, 2, 16)).astype(np.float32)
    return ws, xs


def _jax_chain(ws, xs):
    r = xs
    for i in range(ws.shape[0]):
        r = jnp.tanh(r @ ws[i])
    return r


def _stage(w, x):
    return torch.tanh(x @ w)


def test_tanh_pipeline_equals_the_sequential_chain_and_its_gradient():
    ws, xs = _tanh_case()
    mesh = make_mesh((N_STAGES,), ("stage",), device="cpu")
    w = torch.tensor(ws, requires_grad=True)
    y = pipeline_forward(_stage, w, torch.tensor(xs), mesh, axis="stage")
    assert y.shape == xs.shape
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(_jax_chain(ws, xs)), atol=1e-4)
    loss = pipeline_loss(_stage, lambda y, _: torch.sum(y ** 2), w,
                         torch.tensor(xs), None, mesh, axis="stage")
    loss.backward()
    g_ref = jax.grad(lambda w: jnp.sum(_jax_chain(w, xs) ** 2))(ws)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_ref), atol=1e-3)


def test_one_stage_pipeline_equals_the_references_pipeline_forward():
    """The reference's own ``pipeline_forward`` on the one-stage mesh of
    the single CPU device, forward and ``jax.grad``."""
    ws, xs = _tanh_case(n_stages=1)
    jmesh = jax.make_mesh((1,), ("stage",),
                          axis_types=(jax.sharding.AxisType.Auto,))

    def ref_loss(w):
        y = ref_pipeline_forward(lambda w, x: jnp.tanh(x @ w), w, xs, jmesh,
                                 axis="stage")
        return jnp.sum(y ** 2), y

    with jax.set_mesh(jmesh):
        (_, y_ref), g_ref = jax.jit(jax.value_and_grad(ref_loss,
                                                       has_aux=True))(ws)
    mesh = make_mesh((1,), ("stage",), device="cpu")
    w = torch.tensor(ws, requires_grad=True)
    y = pipeline_forward(_stage, w, torch.tensor(xs), mesh)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_ref), atol=1e-5)


def test_bubble_ticks_are_skipped_with_the_same_result():
    """Each stage runs each microbatch once: n_stages x n_micro calls, not
    the (n_micro + n_stages - 1) x n_stages of the masked schedule."""
    ws, xs = _tanh_case()
    calls = []

    def counted(w, x):
        calls.append(1)
        return _stage(w, x)

    mesh = make_mesh((N_STAGES,), ("stage",), device="cpu")
    y = pipeline_forward(counted, torch.tensor(ws), torch.tensor(xs), mesh)
    assert len(calls) == N_STAGES * xs.shape[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(_jax_chain(ws, xs)),
                               atol=1e-4)


def test_pipeline_refusals():
    ws, xs = _tanh_case()
    mesh = make_mesh((N_STAGES,), ("stage",), device="cpu")
    with pytest.raises(ValueError, match="n_stages=8"):
        pipeline_forward(_stage, torch.tensor(ws[:4]), torch.tensor(xs), mesh)
    with pytest.raises(ValueError, match="wire register"):
        pipeline_forward(lambda w, x: (x @ w)[..., :8], torch.tensor(ws),
                         torch.tensor(xs), mesh)
    with pytest.raises(ValueError, match="no axis 'pipe'"):
        pipeline_forward(_stage, torch.tensor(ws), torch.tensor(xs), mesh,
                         axis="pipe")
    if not torch.cuda.is_available():
        # the mesh's device defaults to cuda, and never falls back
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((N_STAGES,), ("stage",))


def test_decoder_blocks_as_stages_equal_the_references_blocks():
    """A smoke qwen2-0.5b of 4 blocks as 2 stages of 2 blocks over 2
    microbatches of 2 x 8 tokens: output and the blocks' gradients against
    the reference's ``_block_fwd`` chained in JAX."""
    n_layers, n_stages, per = 4, 2, 2
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              n_layers=n_layers)
    jm = jax_get_model(dataclasses.replace(jax_get_config("qwen2-0.5b").smoke(),
                                           n_layers=n_layers, use_scan=False))
    model = get_model(cfg, device="cpu")
    rng = np.random.default_rng(0)

    def draw(entry):
        shape, (kind, val) = entry[:2]
        if kind == "const":
            return np.full(shape, val, np.float32)
        scale = shape[-2] ** -0.5 if val is None else val
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree = L.map_spec(model.param_spec(), draw)
    blocks_np = tree["blocks"]
    xs = rng.standard_normal((2, 2, 8, cfg.d_model)).astype(np.float32)
    positions = jnp.arange(xs.shape[2])

    def jax_loss(blocks):
        h = jnp.asarray(xs.reshape(-1, *xs.shape[2:]))
        for i in range(n_layers):
            h, _ = jm._block_fwd(jax.tree.map(lambda a: a[i], blocks), h,
                                 positions)
        return jnp.sum(h ** 2), h

    (_, h_ref), g_ref = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        blocks_np)

    blocks = params_from_jax(tree, model)["blocks"]
    for leaf in tree_leaves(blocks):
        leaf.requires_grad_(True)
    staged = tree_map(lambda a: a.reshape(n_stages, per, *a.shape[1:]), blocks)
    pos = torch.arange(xs.shape[2])

    def stage_fn(p, h):
        for j in range(per):
            h = model._block_fwd(tree_map(lambda a: a[j], p), h, pos)[0]
        return h

    mesh = make_mesh((n_stages,), ("stage",), device="cpu")
    y = pipeline_forward(stage_fn, staged, torch.tensor(xs), mesh)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(y.detach().numpy().reshape(h_ref.shape),
                               np.asarray(h_ref), atol=1e-5)
    for got, want in zip(tree_leaves(blocks), jax.tree.leaves(g_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
