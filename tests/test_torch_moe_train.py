"""MoE training on the virtual mesh against the JAX package.

The smoke ``dbrx-132b`` (cut to one block) and ``deepseek-v2-236b`` (4
experts top-2) in f32, one numpy weight tree in JAX's layout for both
packages, at the capacity factor E/K = 2, where neither the reference's
dense dispatch nor the EP all-to-all drops a choice:

* the EP step (:class:`repro_torch.train.sharded_step.EPTrainStep`) over 4
  data ranks, one expert a rank, in a scrambled rank order: its loss and
  every leaf's gradient against ``jax.grad`` of the mean, over the 4 data
  shards, of the reference's ``loss`` on each shard's rows (each token's
  expert output is the dense one, each shard's aux the reference's
  per-shard aux), then the parameters after one step against the
  reference's AdamW on the port's gradient and on its own (f32 sums in
  another order: rtol 1e-5 on the loss and the clip's norm, 1e-4 / atol
  1e-5 on gradients and parameters, atol 1e-4 against the reference's
  whole step); an expert gradient scaled by the 4 ranks, the control,
  fails;
* one deepseek-v2 MoE layer (with its shared expert) on a ``(2, 2)``
  ``(data, model)`` mesh, its experts and shared weights in model-axis
  storage: after a forward under inference mode (whose cached index
  tables the run under grad reuses), the output and the gradients of
  every parameter and the input against the reference's ``moe_dense``
  and ``jax.grad`` (rtol 1e-4 / atol 1e-5), each model-axis collective
  counted; with EP disarmed, the dense dispatch on the experts gathered
  whole; and the aux loss under a model axis pinned from the reference's
  own ``_router_probs`` on each shard's tokens;
* the data-parallel MoE step's layer, ``moe_dense_ranks`` on 3 data
  ranks, against the reference's ``moe_dense`` on the global batch at the
  published capacity factor: outputs, aux, the input's and the ranks'
  summed gradients (rtol 1e-4 / atol 1e-5; the aux rtol 1e-6), the mean
  of the ranks' own aux terms, the control, off by more than 1e-5.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import apply_opt as jax_apply_opt  # noqa: E402
from repro.optim import init_opt as jax_init_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM, make_global_batch  # noqa: E402
from repro_torch.kernels import schedule_runner  # noqa: E402
from repro_torch.launch.mesh import PlannedMesh  # noqa: E402
from repro_torch.launch.specs import configure_sp  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import moe_a2a  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.tensor import (  # noqa: E402
    TensorParallel, shard_params, unshard_params)
from repro_torch.train import OverlapGradReducer, certified_allreduce  # noqa: E402
from repro_torch.train.sharded_step import (  # noqa: E402
    expert_leaves, init_sharded_state, make_ep_train_step)
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ROWS, SEQ, D_RANKS = 8, 16, 4


@pytest.fixture(autouse=True)
def _no_ep():
    """The EP and SP states are module state: no test leaves them armed."""
    moe_a2a.clear_ep()
    L.clear_sequence_parallel()
    yield
    moe_a2a.clear_ep()
    L.clear_sequence_parallel()


def _no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)


def _mesh(shape, axes, seed=0):
    n = int(np.prod(shape))
    order = tuple(int(i) for i in np.random.default_rng(seed).permutation(n))
    return PlannedMesh(order=order, shape=shape, axis_names=axes,
                       device=torch.device("cpu"))


def _numpy_tree(spec, seed: int = 0):
    """Weights for both packages in JAX's layout and dtypes (f32 here),
    drawn from the port's spec by a seeded numpy generator at each
    entry's init scale (``tests/test_torch_moe.py``'s draw, which checks
    the tree against JAX's ``init``), constants filled: no JAX compile."""
    rng = np.random.default_rng(seed)

    def draw(entry):
        shape, (kind, val) = entry[:2]
        if kind == "const":
            return np.full(shape, val, np.float32)
        scale = shape[-2] ** -0.5 if val is None else val
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return L.map_spec(spec, draw)


def _allclose(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_ep_step_equals_the_reference_mean_over_shards(arch):
    # dbrx cut to one MoE block (deepseek's two are its dense head block
    # and an MoE block); the layers unrolled: the scanned model's math,
    # compiled faster
    cut = {"dbrx-132b": 1, "deepseek-v2-236b": 2}[arch]
    cfg_t = dataclasses.replace(_no_drop(get_config(arch).smoke()), n_layers=cut)
    cfg_j = dataclasses.replace(_no_drop(jax_get_config(arch).smoke()),
                                n_layers=cut, use_scan=False)
    jm = jax_get_model(cfg_j)
    model = get_model(cfg_t, device="cpu")
    jparams = _numpy_tree(model.param_spec())
    jbatch = jax_host_batch(JaxSyntheticLM(cfg_j.vocab_size, SEQ, ROWS, seed=0), 0)
    shards = {k: jnp.reshape(v, (D_RANKS, ROWS // D_RANKS, SEQ))
              for k, v in jbatch.items()}

    def mean_loss(params, b):
        return jnp.mean(jax.vmap(jm.loss, in_axes=(None, 0))(params, b))

    jloss, jgrads = jax.jit(jax.value_and_grad(mean_loss))(jparams, shards)
    opt = JaxAdamWConfig(lr=1e-3)
    adamw = jax.jit(lambda p, g: jax_apply_opt(opt, p, g, jax_init_opt(p)))
    want_params, _, _ = adamw(jparams, jgrads)

    mesh = _mesh((D_RANKS,), ("data",))
    configure_sp(cfg_t, mesh)
    reducer = OverlapGradReducer(certified_allreduce(D_RANKS, 1 << 16, "ring"),
                                 bucket_bytes=1 << 16, transport="runner")
    step = make_ep_train_step(model, AdamWConfig(lr=1e-3), mesh, reducer)
    state = init_sharded_state(model, torch.Generator(), step.layout)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    state = state._replace(params=params)
    batch = make_global_batch(SyntheticLM(cfg_t.vocab_size, SEQ, ROWS, seed=0),
                              0, mesh, shd.batch_spec(mesh))
    loss, grads = step.value_and_grad(params, batch)
    _allclose(loss, jloss, rtol=1e-5, atol=0)
    got, want = tree_leaves(grads), jax.tree.leaves(jgrads)
    experts = expert_leaves(grads)
    assert len(got) == len(want) and sum(experts) == 3
    for g, w in zip(got, want):
        _allclose(g, w)
    # the control: an expert's gradient d times too large
    i = experts.index(True)
    with pytest.raises(AssertionError):
        _allclose(got[i] * D_RANKS, want[i])
    # the reference's AdamW on the port's gradients, element for element
    # (the clip, the ZeRO-1 slices and the all-gather); then against the
    # reference's whole step: AdamW's first update is g / (|g| + eps) * lr,
    # which turns the rounding of near-zero gradients into up to 1e-5 of
    # a parameter, so it is held as test_torch_tensor_parallel.py holds it
    ref_p, _, ref_m = adamw(jparams, jax.tree.unflatten(
        jax.tree.structure(jparams), [g.numpy() for g in got]))
    new_state, metrics = step.apply(state, grads)
    for p, w, w_step in zip(tree_leaves(new_state.params),
                            jax.tree.leaves(ref_p),
                            jax.tree.leaves(want_params)):
        _allclose(p, w)
        _allclose(p, w_step, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-5)
    # one all-reduce of the replicated leaves; one all-gather a leaf with
    # ZeRO-1 moments
    assert int(new_state.step) == 1 and step.counts["data_allreduce"] == 1
    assert step.counts["data_allgather"] == step.layout.counts()["zero1_sliced"]


def test_moe_layer_on_a_data_model_mesh_equals_moe_dense():
    cfg_t = _no_drop(get_config("deepseek-v2-236b").smoke())
    cfg_j = _no_drop(jax_get_config("deepseek-v2-236b").smoke())
    spec = L.moe_spec(cfg_t)
    rng = np.random.default_rng(3)
    # every weight at its fan-in's scale
    p_np = L.map_spec(spec, lambda e: (rng.standard_normal(e[0])
                                       * e[0][-2] ** -0.5).astype(np.float32))
    x_np = rng.standard_normal((4, SEQ, cfg_t.d_model)).astype(np.float32)
    cot = rng.standard_normal(x_np.shape).astype(np.float32)

    def ref(p, x):
        y, _ = JL.moe_dense(p, x, cfg_j)
        return jnp.sum(y * cot), y

    (_, y_ref), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(p_np, x_np)

    mesh = _mesh((2, 2), ("data", "model"))
    moe_a2a.arm_ep(mesh)
    pspecs = shd.param_pspecs({"moe": p_np}, cfg_t, mesh)["moe"]
    assert pspecs["w1"] == shd.P("data", None, "model")
    tp = TensorParallel(mesh, pspecs)
    logical = jax.tree.map(torch.from_numpy, p_np)
    storage = [t.requires_grad_() for t in tree_leaves(
        shard_params(logical, pspecs, 2))]
    # a forward under inference mode first: the runner's cached index
    # tables must serve the run under grad after it
    schedule_runner.device_tables.cache_clear()
    with torch.inference_mode():
        L.moe_layer(tree_unflatten(logical, [t.detach() for t in storage]),
                    torch.from_numpy(x_np), cfg_t,
                    tp=TensorParallel(mesh, pspecs))
    x = torch.from_numpy(x_np).requires_grad_()
    y, aux = L.moe_layer(tree_unflatten(logical, storage), x, cfg_t, tp=tp)
    (y * torch.from_numpy(cot)).sum().backward()
    _allclose(y, y_ref)
    _allclose(x.grad, gx_ref)
    grads = unshard_params(tree_unflatten(logical, [t.grad for t in storage]),
                           pspecs)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(gp_ref)):
        _allclose(g, w)
    # the experts and shared experts gathered (3 + 3 leaves on each of the
    # 2 data ranks), reduce-scattered back; the router's gradient
    # all-reduced on each; the input's slices and the outputs gathered
    assert tp.counts == {"allgather": 12 + 2 + 2, "reducescatter": 12,
                         "allreduce": 2}

    # EP disarmed (a model axis without a data axis to spread the experts
    # over): the dense dispatch on the experts gathered whole
    moe_a2a.clear_ep()
    with torch.no_grad():
        y_dense, _ = L.moe_layer(tree_unflatten(logical, storage), x, cfg_t,
                                 tp=TensorParallel(mesh, pspecs))
    _allclose(y_dense, y_ref)

    # the aux loss: the reference's pmean runs over the EP axis only, so the
    # two model columns, routing different halves of S, claim one
    # replicated value and hold two; the port averages over them too
    per = [[float(JL._router_probs(p_np, x_np[2 * r:2 * r + 2, j * 8:j * 8 + 8]
                                   .reshape(-1, cfg_t.d_model), cfg_j)[2])
            for j in range(2)] for r in range(2)]
    columns = np.mean(per, axis=0)
    assert abs(columns[0] - columns[1]) > 1e-3
    np.testing.assert_allclose(float(aux.detach()), np.mean(per), rtol=1e-5)


def test_moe_dense_ranks_equals_moe_dense_on_the_global_batch():
    """The data-parallel MoE step's layer: ``moe_dense_ranks`` on 3 data
    ranks, each its own view of the layer, against the reference's
    ``moe_dense`` on the global batch at the published capacity factor
    (a dispatch group is a row, so the ranks drop what the global batch
    drops): the outputs, the aux loss, the input's gradient and the
    ranks' summed gradients; a mean of the ranks' own aux terms, the
    control, is off."""
    cfg_t = get_config("dbrx-132b").smoke()
    cfg_j = jax_get_config("dbrx-132b").smoke()
    d, rows = 3, 2
    rng = np.random.default_rng(6)
    # every weight at its fan-in's scale, as the layer test above draws them
    p_np = L.map_spec(L.moe_spec(cfg_t), lambda e: (
        rng.standard_normal(e[0]) * e[0][-2] ** -0.5).astype(np.float32))
    x_np = rng.standard_normal((d * rows, SEQ, cfg_t.d_model)).astype(np.float32)
    cot = rng.standard_normal(x_np.shape).astype(np.float32)

    def ref(p, x):
        y, aux = JL.moe_dense(p, x, cfg_j)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y_ref, aux_ref)), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(p_np, x_np)

    names = sorted(p_np)
    bufs = {k: torch.zeros((d, *p_np[k].shape)) for k in names}
    views = []
    for r in range(d):
        v = {k: torch.from_numpy(p_np[k]).requires_grad_() for k in names}
        for k in names:
            v[k].grad = bufs[k][r]
        views.append(v)
    xs = [torch.from_numpy(x_np[r * rows:(r + 1) * rows]).requires_grad_()
          for r in range(d)]
    ys, aux = L.moe_dense_ranks(views, xs, cfg_t)
    (sum((y * torch.from_numpy(cot[r * rows:(r + 1) * rows])).sum()
         for r, y in enumerate(ys)) + aux).backward()
    _allclose(torch.cat(ys), y_ref)
    np.testing.assert_allclose(float(aux.detach()), float(aux_ref), rtol=1e-6)
    _allclose(torch.cat([x.grad for x in xs]), gx_ref)
    for k in names:
        _allclose(bufs[k].sum(0), gp_ref[k])
    own = np.mean([float(JL._router_probs(
        p_np, x_np[r * rows:(r + 1) * rows].reshape(-1, SEQ, cfg_j.d_model),
        cfg_j)[2]) for r in range(d)])
    assert abs(own - float(aux_ref)) > 1e-5 * abs(float(aux_ref))
