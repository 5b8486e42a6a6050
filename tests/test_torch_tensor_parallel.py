"""Tensor parallelism and ZeRO-1 on the virtual mesh against the JAX package.

The smoke qwen2-0.5b in f32, from JAX's init, on one global batch: the
tensor-parallel loss and its unsharded gradients against
``jax.value_and_grad(model.loss)``, one sharded step (the clip, AdamW on
ZeRO-1 slices, the data-axis all-gather) against ``make_train_step``, and
every model-axis sum counted through ``run_schedule``.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import apply_opt as jax_apply_opt  # noqa: E402
from repro.optim import init_opt as jax_init_opt  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM, host_batch, make_global_batch  # noqa: E402
from repro_torch.kernels import schedule_runner  # noqa: E402
from repro_torch.launch.mesh import PlannedMesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel import tensor as tpm  # noqa: E402
from repro_torch.parallel.tensor import shard_params, unshard_params  # noqa: E402
from repro_torch.train import OverlapGradReducer, certified_allreduce  # noqa: E402
from repro_torch.train.sharded_step import (  # noqa: E402
    _unslice, init_sharded_state, make_sharded_train_step)
from repro_torch.train.train_step import (  # noqa: E402
    batch_on, jit_train_step, value_and_grad)
from repro_torch.tree import tree_leaves  # noqa: E402

ROWS, SEQ = 8, 16
MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((1, 2, 2), ("pod", "data", "model"))]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(cfg_port, cfg_jax):
    jm = jax_get_model(cfg_jax)
    jstate = jax.jit(lambda k: jax_init_state(jm, k))(jax.random.PRNGKey(0))
    ds = SyntheticLM(cfg_port.vocab_size, SEQ, ROWS, seed=0)
    jbatch = jax_host_batch(JaxSyntheticLM(cfg_jax.vocab_size, SEQ, ROWS, seed=0), 0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jstate.params, jbatch)
    model = get_model(cfg_port, device="cpu")
    return dict(jm=jm, jstate=jstate, jbatch=jbatch, ds=ds, loss=loss,
                grads=grads, model=model,
                params=params_from_jax(_np_tree(jstate.params), model))


@pytest.fixture(scope="module")
def qwen():
    s = _setup(get_config("qwen2-0.5b").smoke(),
               jax_get_config("qwen2-0.5b").smoke())
    # make_train_step is value_and_grad then apply_opt: one compile of
    # each, the second reused on the port's gradients
    s["apply_opt"] = jax.jit(functools.partial(jax_apply_opt,
                                               JaxAdamWConfig(lr=1e-3)))
    params, opt, metrics = s["apply_opt"](
        s["jstate"].params, s["grads"], jax_init_opt(s["jstate"].params))
    s["step_params"], s["step_metrics"] = params, dict(metrics, loss=s["loss"])
    return s


def _mesh(shape, axes, seed=0):
    n = int(np.prod(shape))
    order = tuple(int(i) for i in np.random.default_rng(seed).permutation(n))
    return PlannedMesh(order=order, shape=shape, axis_names=axes,
                       device=torch.device("cpu"))


def _step(model, mesh, opt=None):
    sizes = shd.mesh_axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in shd.dp_axes(mesh)]))
    reducer = None
    if dp > 1:
        reducer = OverlapGradReducer(certified_allreduce(dp, 1 << 16, "ring"),
                                     bucket_bytes=1 << 16, mode="bucketed",
                                     transport="runner")
    return make_sharded_train_step(model, opt or AdamWConfig(lr=1e-3), mesh,
                                   reducer)


def _close(got, want, rtol, atol):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol, atol=atol)


def _reckon(cfg, m, dp):
    """Model-axis schedule runs of one step, from the specs' choices.

    A data-parallel rank's forward: the embedding's all-reduce; each
    block's attention and MLP all-reduce where sharded; the loss's gather
    of logz and its gold all-reduce.  Its backward: one all-reduce a
    column-parallel input (the attention's query input, its k and v too
    where the KV heads stay whole, the MLP's, the head's).  The block's
    checkpoint recomputes up to the last tensor the backward saved: the
    attention's all-reduce, not the MLP's, which ends the block.  Then
    the clip's one all-reduce a step.
    """
    heads, kv = cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0
    mlp, vocab = cfg.d_ff % m == 0, cfg.vocab_size % m == 0
    L = cfg.n_layers
    fwd = vocab + L * (heads + mlp) + vocab
    bwd = L * (heads * (1 + 2 * (not kv)) + mlp) + vocab
    recompute = L * heads
    return {"allreduce": dp * (fwd + bwd + recompute) + 1,
            "allgather": dp * vocab}


@pytest.mark.parametrize("shape,axes", MESHES)
def test_tp_loss_and_grads_equal_the_reference(qwen, shape, axes):
    mesh = _mesh(shape, axes)
    step = _step(qwen["model"], mesh)
    storage = shard_params(qwen["params"], step.layout.pspecs, step.layout.m)
    batch = make_global_batch(qwen["ds"], 0, mesh, shd.batch_spec(mesh))
    loss, grads = step.value_and_grad(storage, batch)
    np.testing.assert_allclose(float(loss), float(qwen["loss"]), rtol=1e-5)
    _close(unshard_params(grads, step.layout.pspecs), qwen["grads"],
           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_one_sharded_step_equals_the_reference_step(qwen, shape, axes):
    """The clip, AdamW on each rank's ZeRO-1 slice and the all-gather
    give the reference's parameters, moments and metrics."""
    mesh = _mesh(shape, axes, seed=1)
    step = _step(qwen["model"], mesh)
    lay = step.layout
    gen = torch.Generator()
    gen.manual_seed(0)
    state0 = init_sharded_state(qwen["model"], gen, lay)
    state0 = state0._replace(params=shard_params(qwen["params"], lay.pspecs, lay.m))
    assert all(z is not None for z in lay.zdims) or lay.dp == 1
    batch = make_global_batch(qwen["ds"], 0, mesh, shd.batch_spec(mesh))
    _, grads = step.value_and_grad(state0.params, batch)
    state, metrics = step(state0, batch)
    params = unshard_params(state.params, lay.pspecs)
    moments = [unshard_params(_unslice_tree(tree, lay), lay.pspecs)
               for tree in (state.opt.m, state.opt.v)]
    # the reference's AdamW on the port's gradients: the clip, the ZeRO-1
    # slices and the all-gather, element for element
    g = jax.tree.unflatten(jax.tree.structure(qwen["jstate"].params), [
        t.numpy() for t in tree_leaves(unshard_params(grads, lay.pspecs))])
    ref_p, ref_opt, ref_m = qwen["apply_opt"](
        qwen["jstate"].params, g, jax_init_opt(qwen["jstate"].params))
    _close(params, ref_p, rtol=1e-4, atol=1e-5)
    _close(moments[0], ref_opt.m, rtol=1e-4, atol=1e-6)
    _close(moments[1], ref_opt.v, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-5)
    # the whole step against make_train_step's: AdamW's first update is
    # g / (|g| + eps) * lr, which turns the ~1e-9 rounding of the qkv
    # biases' near-zero gradients into up to 1e-5 of a parameter, so the
    # parameters are held as test_torch_train.py holds the overlapped step
    _close(params, qwen["step_params"], rtol=0, atol=1e-4)
    wm = qwen["step_metrics"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]), rtol=1e-5)
    assert int(state.step) == 1 and int(state.opt.count) == 1


def _unslice_tree(tree, lay):
    from repro_torch.tree import tree_unflatten

    leaves = [t if z is None else _unslice(t, z)
              for t, z in zip(tree_leaves(tree), lay.zdims)]
    return tree_unflatten(tree, leaves)


@pytest.mark.parametrize("shape,axes", [MESHES[1], MESHES[2]])
def test_every_model_axis_sum_runs_a_certified_schedule(qwen, shape, axes,
                                                         monkeypatch):
    """A spy on ``run_schedule``: every model-axis collective of a step
    runs there, as many as the reckoning says (at ``(2, 4)`` the KV heads
    stay whole, so k and v each add a backward all-reduce a block)."""
    seen = []
    inner = schedule_runner.run_schedule

    def spy(x, schedule, use_kernel_add=True):
        seen.append((schedule.postcondition, schedule.n, tuple(x.shape)))
        return inner(x, schedule, use_kernel_add)

    monkeypatch.setattr(tpm, "run_schedule", spy)
    mesh = _mesh(shape, axes)
    step = _step(qwen["model"], mesh)
    lay = step.layout
    gen = torch.Generator()
    state = init_sharded_state(qwen["model"], gen, lay)
    step(state, make_global_batch(qwen["ds"], 0, mesh, shd.batch_spec(mesh)))
    want = _reckon(qwen["model"].cfg, lay.m, lay.dp)
    got = {"allreduce": sum(p == "allreduce" for p, *_ in seen),
           "allgather": sum(p == "all_gather" for p, *_ in seen)}
    assert got == {"allreduce": want["allreduce"],
                   "allgather": want["allgather"] + 1}   # + ZeRO-1's, data axis
    assert step.counts == {"model_allreduce": want["allreduce"],
                           "model_allgather": want["allgather"],
                           "data_allgather": 1, "data_allreduce": 1}
    # each model-axis run carries the m ranks' rows
    assert all(n == lay.m and x[0] == lay.m for p, n, x in seen
               if p == "allreduce")
    # the GQA case at model 4: query heads shard, KV heads stay whole
    kv_whole = qwen["model"].cfg.n_kv_heads % lay.m != 0
    assert (tpm.model_dim(lay.pspecs["blocks"]["attn"]["wk"]) is None) == kv_whole


def test_the_clip_counts_a_replicated_leaf_once(qwen):
    """The clip's norm counts a replicated leaf (the norms' weights, and
    at model 4 ``wk``/``wv``) once and sums the sharded ones over the
    model ranks: the reference's norm.  Counted on every rank, ``m`` times
    in all, the norm would leave the reference's by far more than the
    tolerance, so this comparison catches that fault."""
    mesh = _mesh((2, 4), ("data", "model"))
    step = _step(qwen["model"], mesh)
    lay = step.layout
    storage = shard_params(qwen["params"], lay.pspecs, lay.m)
    _, grads = step.value_and_grad(
        storage, make_global_batch(qwen["ds"], 0, mesh, shd.batch_spec(mesh)))
    want = float(qwen["step_metrics"]["grad_norm"])
    got = float(step.tp.global_norm(grads))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    replicated = sum(float(torch.sum(torch.square(g)))
                     for g, s in zip(tree_leaves(grads), tree_leaves(lay.pspecs))
                     if tpm.model_dim(s) is None)
    assert replicated > 0
    counted_m_times = (got ** 2 + (lay.m - 1) * replicated) ** 0.5
    assert abs(counted_m_times - want) > 1e3 * 1e-5 * want, (counted_m_times, want)


def test_attention_stays_whole_where_the_heads_do_not_divide():
    """Six heads on a model axis of 4 (as qwen2-0.5b's 14): the attention
    is computed whole on every rank while the MLP and the vocabulary
    shard; loss and gradients are the unsharded model's (held to the
    reference's by ``test_torch_train.py``)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), n_heads=6,
                              n_kv_heads=2, n_layers=1)
    model = get_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=0)
    want_loss, want = value_and_grad(model, params, batch_on(
        host_batch(ds, 0), "cpu"))
    mesh = _mesh((1, 4), ("data", "model"))
    step = _step(model, mesh)
    attn = step.layout.pspecs["blocks"]["attn"]
    assert all(tpm.model_dim(attn[k]) is None for k in attn)
    assert tpm.model_dim(step.layout.pspecs["blocks"]["mlp"]["w1"]) == 2
    storage = shard_params(params, step.layout.pspecs, step.layout.m)
    loss, grads = step.value_and_grad(
        storage, make_global_batch(ds, 0, mesh, shd.batch_spec(mesh)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(unshard_params(grads, step.layout.pspecs)),
                    tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
    # no clip in value_and_grad: the reckoning's all-reduces but the clip's
    assert step.tp.counts == {
        "allreduce": _reckon(cfg, 4, 1)["allreduce"] - 1, "allgather": 1}


def test_jit_train_step_takes_the_references_signature(qwen):
    """``overlap="off"`` gives the sharded step; an overlap mode delegates
    to the overlapped data-parallel step, the reducer's mode replaced."""
    mesh = _mesh((2, 2), ("data", "model"))
    red = OverlapGradReducer(certified_allreduce(2, 1 << 16, "ring"),
                             bucket_bytes=1 << 16, mode="sequential",
                             transport="runner")
    step = jit_train_step(qwen["model"], AdamWConfig(), qwen["model"].cfg, mesh,
                          None, None, reducer=red)
    assert step.layout.m == 2 and step.reducer is red
    with pytest.raises(ValueError, match="needs a reducer"):
        jit_train_step(qwen["model"], AdamWConfig(), None, mesh,
                       overlap="bucketed")
    fn = jit_train_step(qwen["model"], AdamWConfig(), None, mesh,
                        overlap="fused", reducer=red)
    assert callable(fn) and not hasattr(fn, "layout")


@pytest.mark.parametrize("arch,item", [("rwkv6-1.6b", "item 20"),
                                       ("recurrentgemma-9b", "item 21"),
                                       ("deepseek-v2-236b", "item 23")])
def test_families_without_a_tp_forward_name_their_item(arch, item):
    model = get_model(get_config(arch).smoke(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        make_sharded_train_step(model, AdamWConfig(),
                                _mesh((1, 2), ("data", "model")))
