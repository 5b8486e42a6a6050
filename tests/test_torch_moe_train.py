"""MoE training on the virtual mesh against the JAX package.

The smoke ``dbrx-132b`` (cut to one block) and ``deepseek-v2-236b`` (4
experts top-2) in f32, one numpy weight tree in JAX's layout for both
packages, at the capacity factor E/K = 2, where neither the reference's
dense dispatch nor the EP all-to-all drops a choice:

* the EP step (:class:`repro_torch.train.sharded_step.EPTrainStep`) over 4
  data ranks, one expert a rank, in a scrambled rank order; deepseek-v2's
  on ``(2, 2)`` (its MLA and dense head block on the model axis); dbrx's
  and deepseek-v2's on a ``(2, 2, 1)`` (pod, data, model) mesh: its loss
  and every leaf's gradient against ``jax.grad`` of the mean, over the
  data-parallel shards, of the reference's ``loss`` on each shard's rows
  (each token's expert output is the dense one, each shard's aux the
  reference's per-shard aux, under a model axis the mean of its columns'),
  then the parameters after one step against the reference's AdamW on
  the port's gradient and on its own (f32 sums in another order: rtol
  1e-5 on the loss and the clip's norm, 1e-4 / atol 1e-5 on gradients
  and parameters, atol 1e-4 against the reference's whole step); an
  expert gradient summed over the ranks, the control, fails;
* MLA over a model axis of 2 against the reference's ``mla_attention``;
* the EP layer on a ``(2, 2, 1)`` mesh against ``moe_dense`` on the
  global batch, its aux the mean over every pod's shards;
* the EP step's memory reckoning, a gradient buffer a pod;
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
import functools
import json

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
from repro_torch.kernels import accounting, schedule_runner  # noqa: E402
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


#: the EP step's meshes: each data-parallel rank's shard of the 8 rows
#: (the 4 of a ``(2, 2, 1)`` mesh are its 2 pods x 2 data ranks; the 2 of
#: ``(2, 2)`` route each half of S in a model column of its own)
EP_CASES = [
    pytest.param("dbrx-132b", (4,), id="dbrx-132b"),
    pytest.param("deepseek-v2-236b", (4,), id="deepseek-v2-236b"),
    pytest.param("deepseek-v2-236b", (2, 2), id="deepseek-v2-236b-2x2"),
    pytest.param("dbrx-132b", (2, 2, 1), id="dbrx-132b-2x2x1"),
    pytest.param("deepseek-v2-236b", (2, 2, 1), id="deepseek-v2-236b-2x2x1"),
]
AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


@functools.lru_cache(maxsize=None)
def _ep_reference(arch: str, shards: int, columns: int):
    """The reference's side of the EP step's test, once an ``(arch,
    shards, columns)``: the cut smoke configs and the port's model, the
    numpy weights, ``jax.value_and_grad`` of the mean over ``shards`` of
    the reference's ``loss`` on each shard's rows, its AdamW step, and the
    jitted AdamW.  Under a model axis each shard's aux loss is the mean of
    its ``columns`` slices of S, each routed alone (ROADMAP.md §3: the
    port's aux under a model axis; the reference's ``moe_layer`` is
    wrapped for the trace only)."""
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
    per = {k: jnp.reshape(v, (shards, ROWS // shards, SEQ))
           for k, v in jbatch.items()}
    moe_layer = JL.moe_layer

    def column_aux(p, x, cfg):
        y, aux = moe_layer(p, x, cfg)
        if columns == 1:
            return y, aux
        return y, jnp.mean(jnp.stack([
            JL._router_probs(p, c.reshape(-1, c.shape[-1]), cfg)[2]
            for c in jnp.split(x, columns, axis=1)]))

    def mean_loss(params, b):
        return jnp.mean(jax.vmap(jm.loss, in_axes=(None, 0))(params, b))

    JL.moe_layer = column_aux
    try:
        jloss, jgrads = jax.jit(jax.value_and_grad(mean_loss))(jparams, per)
    finally:
        JL.moe_layer = moe_layer
    opt = JaxAdamWConfig(lr=1e-3)
    adamw = jax.jit(lambda p, g: jax_apply_opt(opt, p, g, jax_init_opt(p)))
    want_params, _, _ = adamw(jparams, jgrads)
    return cfg_t, model, jparams, jloss, jgrads, want_params, adamw


@pytest.mark.parametrize("arch,shape", EP_CASES)
def test_ep_step_equals_the_reference_mean_over_shards(arch, shape):
    axes = AXES[len(shape)]
    sizes = dict(zip(axes, shape))
    pods, m = sizes.get("pod", 1), sizes.get("model", 1)
    dp = pods * sizes["data"]
    cfg_t, model, jparams, jloss, jgrads, want_params, adamw = _ep_reference(
        arch, dp, m)

    mesh = _mesh(shape, axes)
    configure_sp(cfg_t, mesh)
    reducer = OverlapGradReducer(certified_allreduce(dp, 1 << 16, "ring"),
                                 bucket_bytes=1 << 16, transport="runner")
    step = make_ep_train_step(model, AdamWConfig(lr=1e-3), mesh, reducer)
    pspecs = step.layout.pspecs
    state = init_sharded_state(model, torch.Generator(), step.layout)
    params = shard_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          model), pspecs, m)
    state = state._replace(params=params)
    batch = make_global_batch(SyntheticLM(cfg_t.vocab_size, SEQ, ROWS, seed=0),
                              0, mesh, shd.batch_spec(mesh))
    loss, grads = step.value_and_grad(params, batch)
    _allclose(loss, jloss, rtol=1e-5, atol=0)
    got = tree_leaves(unshard_params(grads, pspecs))
    want = jax.tree.leaves(jgrads)
    experts = expert_leaves(grads)
    assert len(got) == len(want) and sum(experts) == 3
    for g, w in zip(got, want):
        _allclose(g, w)
    # the control: an expert's gradient summed over the ranks, not averaged
    i = experts.index(True)
    with pytest.raises(AssertionError):
        _allclose(got[i] * dp, want[i])
    # the reference's AdamW on the port's gradients, element for element
    # (the clip, the ZeRO-1 slices and the all-gathers); then against the
    # reference's whole step: AdamW's first update is g / (|g| + eps) * lr,
    # which turns the rounding of near-zero gradients into up to 1e-5 of
    # a parameter, so it is held as test_torch_tensor_parallel.py holds it
    ref_p, _, ref_m = adamw(jparams, jax.tree.unflatten(
        jax.tree.structure(jparams), [g.numpy() for g in got]))
    new_state, metrics = step.apply(state, grads)
    for p, w, w_step in zip(tree_leaves(unshard_params(new_state.params, pspecs)),
                            jax.tree.leaves(ref_p),
                            jax.tree.leaves(want_params)):
        _allclose(p, w)
        _allclose(p, w_step, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-5)
    # one all-reduce of the replicated leaves; one all-gather a leaf with
    # ZeRO-1 moments: over the pod axis for the experts, whose moments a
    # pod mesh slices over the pods, and one pod-axis all-reduce of the
    # experts' gradients there
    counts = step.counts
    assert int(new_state.step) == 1 and counts["data_allreduce"] == 1
    assert counts["data_allgather"] + counts.get("pod_allgather", 0) == \
        step.layout.counts()["zero1_sliced"]
    if pods > 1:
        assert counts["pod_allreduce"] == 1 and counts["pod_allgather"] == 3
        assert [z for z, e in zip(step.layout.zn, experts) if e] == [pods] * 3
    else:
        assert "pod_allreduce" not in counts


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mla_attention_on_a_model_axis_equals_the_reference(shape):
    """deepseek-v2's MLA over a model axis of 2 (each data rank's rows
    through :func:`~repro_torch.models.layers.mla_attention_tp`): the
    output and the gradients of the input and every parameter, unsharded,
    against the reference's ``mla_attention`` and ``jax.grad`` (rtol 1e-4
    / atol 1e-5); a data rank's 4 model-axis all-reduces (``wo``'s, and
    the three latents' gradients in the backward)."""
    cfg_t = get_config("deepseek-v2-236b").smoke()
    cfg_j = jax_get_config("deepseek-v2-236b").smoke()
    p_np = _numpy_tree(L.mla_spec(cfg_t), seed=4)
    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((4, SEQ, cfg_t.d_model)).astype(np.float32)
    cot = rng.standard_normal(x_np.shape).astype(np.float32)
    y_ref, gp_ref, gx_ref = _mla_reference(p_np, x_np, cot, cfg_j)

    mesh = _mesh(shape, ("data", "model"))
    pspecs = shd.param_pspecs({"attn": p_np}, cfg_t, mesh)["attn"]
    assert (pspecs["wq_b"], pspecs["wkv_b"], pspecs["wo"]) == \
        (shd.P(None, "model"), shd.P(None, "model"), shd.P("model", None))
    assert all(pspecs[k] == shd.P(None, None)
               for k in ("wq_a", "wkv_a", "wk_rope"))
    tp = TensorParallel(mesh, pspecs)
    logical = jax.tree.map(torch.from_numpy, p_np)
    storage = [t.requires_grad_() for t in tree_leaves(
        shard_params(logical, pspecs, 2))]
    tree = tree_unflatten(logical, storage)
    d = shape[0]
    rows = x_np.shape[0] // d
    x = torch.from_numpy(x_np).requires_grad_()
    positions = torch.arange(SEQ)
    y = torch.cat([L.mla_attention_tp(tree, pspecs, x[r * rows:(r + 1) * rows],
                                      cfg_t, tp, positions=positions)
                   for r in range(d)])
    (y * torch.from_numpy(cot)).sum().backward()
    _allclose(y, y_ref)
    _allclose(x.grad, gx_ref)
    grads = unshard_params(tree_unflatten(logical, [t.grad for t in storage]),
                           pspecs)
    for k in p_np:
        _allclose(grads[k], gp_ref[k])
    assert tp.counts == {"allreduce": 4 * d, "allgather": 0}


@functools.lru_cache(maxsize=None)
def _mla_jit(cfg_j):
    def ref(p, x, cot):
        y, _ = JL.mla_attention(p, x, cfg_j)
        return jnp.sum(y * cot), y

    return jax.jit(jax.value_and_grad(ref, argnums=(0, 1), has_aux=True))


def _mla_reference(p_np, x_np, cot, cfg_j):
    (_, y), (gp, gx) = _mla_jit(cfg_j)(p_np, x_np, cot)
    return y, gp, gx


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


def test_moe_layer_on_a_pod_mesh_equals_moe_dense():
    """The EP layer on a ``(2, 2, 1)`` (pod, data, model) mesh, one row a
    data-parallel rank: each pod's 2 data ranks run their own all-to-all,
    the experts split over ``data`` and replicated over the pods; one
    parameter tree serves every rank, so its gradients sum the pods'.
    The output and the gradients of the input and every parameter
    against the reference's ``moe_dense`` on the global batch at the
    capacity factor E/K (rtol 1e-4 / atol 1e-5); one rank's all-to-alls
    counted by hand (a pod's runs one after another on the virtual mesh,
    a rank taking part in one).  The aux loss: the reference's ``pmean``
    over ``data`` alone leaves the two pods' values apart (by more than
    1e-3 here); the port's is the mean over all 4 shards (rtol 1e-5;
    ROADMAP.md §3)."""
    cfg_t = _no_drop(get_config("dbrx-132b").smoke())
    cfg_j = _no_drop(jax_get_config("dbrx-132b").smoke())
    rng = np.random.default_rng(7)
    p_np = L.map_spec(L.moe_spec(cfg_t), lambda e: (
        rng.standard_normal(e[0]) * e[0][-2] ** -0.5).astype(np.float32))
    x_np = rng.standard_normal((4, SEQ, cfg_t.d_model)).astype(np.float32)
    cot = rng.standard_normal(x_np.shape).astype(np.float32)

    def ref(p, x):
        y, _ = JL.moe_dense(p, x, cfg_j)
        return jnp.sum(y * cot), y

    (_, y_ref), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(p_np, x_np)

    moe_a2a.arm_ep(_mesh((2, 2, 1), AXES[3]))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in p_np.items()}
    x = torch.from_numpy(x_np).requires_grad_()
    with accounting.KernelWork() as kw:
        y, aux = L.moe_layer(p, x, cfg_t)
        (y * torch.from_numpy(cot)).sum().backward()
    _allclose(y, y_ref)
    _allclose(x.grad, gx_ref)
    for k in p_np:
        _allclose(p[k].grad, gp_ref[k])
    # a rank's: the tokens' dispatch and return and the ids' dispatch, the
    # two token all-to-alls' backward; n x C pieces of its one row
    n, K = 2, cfg_t.moe_top_k
    C = max(int(np.ceil(SEQ * K / n * cfg_t.capacity_factor)), K)
    tokens, ids = n * C * cfg_t.d_model * 4, n * C * 8
    assert kw.collectives()["all-to-all"] == (5, 4 * tokens + ids)
    per = [float(JL._router_probs(p_np, x_np[r], cfg_j)[2]) for r in range(4)]
    assert abs(np.mean(per[:2]) - np.mean(per[2:])) > 1e-3
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


def test_ep_memory_counts_the_pods_expert_gradient_buffers():
    """The EP step's memory, reckoned before any weight is drawn: on a pod
    axis each pod's ranks write their experts' gradients into a buffer of
    their own, and the pod axis's reducer returns their mean; a card
    smaller than the reckoning refuses ``build_train_step`` in words,
    the CPU nothing."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import _meta_model
    from repro_torch.launch.train import build_train_step
    from repro_torch.train.sharded_step import param_shapes, reckon_ep_memory

    cfg = get_config("dbrx-132b").smoke()
    model = _meta_model(cfg)
    shapes = param_shapes(model)
    experts = sum(t.numel() * 4 for t, e in zip(tree_leaves(shapes),
                                                expert_leaves(shapes)) if e)
    flat, pods = reckon_ep_memory(shapes, 4), reckon_ep_memory(shapes, 2, 2)
    assert flat["expert_gradients"] == experts > 0
    assert pods["expert_gradients"] == 2 * experts
    assert pods["mean"] == flat["mean"] + experts
    assert pods["total"] == flat["total"] + 2 * experts
    assert pods["replicated_gradients"] == flat["replicated_gradients"]
    mesh = make_mesh((2, 2, 1), AXES[3], "cpu")
    lines = []
    with pytest.raises(ValueError, match="the EP step's memory is reckoned "
                                         "at weights .* over the card's"):
        build_train_step(cfg, mesh, "cpu", model=model, card_bytes=10 ** 6,
                         log=lines.append)
    assert lines == ["[train] memory " + json.dumps(dict(pods, card_bytes=10 ** 6))]
    build = build_train_step(cfg, mesh, "cpu", model=model)
    assert build.kind == "ep" and build.memory == pods
    assert build.sharded.pod_reducer.n == 2
