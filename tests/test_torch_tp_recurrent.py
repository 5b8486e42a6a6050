"""Tensor parallelism of the two recurrent families against the JAX package.

The smoke rwkv6-1.6b (2 blocks, 4 heads) and the smoke recurrentgemma-9b
at 5 layers (one R, R, A group and an R, R tail) with a window of 8 under
a 16-token sequence, in f32, on one weight tree, one global batch: the
tensor-parallel loss and its unsharded gradients against
``jax.value_and_grad(model.loss)`` on ``(1, 2)``, ``(2, 2)`` and ``(1, 2,
2)``; one sharded step against the reference's ``apply_opt``; every
model-axis collective of a step counted through ``run_schedule`` against
a reckoning made by hand from the specs.
"""

import dataclasses
import functools

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
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import apply_opt as jax_apply_opt  # noqa: E402
from repro.optim import init_opt as jax_init_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM, make_global_batch  # noqa: E402
from repro_torch.launch.mesh import PlannedMesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel import tensor as tpm  # noqa: E402
from repro_torch.parallel.tensor import shard_params, unshard_params  # noqa: E402
from repro_torch.train import OverlapGradReducer, certified_allreduce  # noqa: E402
from repro_torch.train.sharded_step import (  # noqa: E402
    _unslice, init_sharded_state, make_sharded_train_step)
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ROWS, SEQ = 8, 16
ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")
MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2, 2), ("pod", "data", "model"))]
#: the hybrid with a tail (5 layers: one R, R, A group, then R, R) and a
#: window shorter than the sequence
HYBRID = dict(n_layers=5, attn_window=8)


def _configs(arch):
    port, ref = get_config(arch).smoke(), jax_get_config(arch).smoke()
    if arch == "recurrentgemma-9b":
        port = dataclasses.replace(port, **HYBRID)
        ref = dataclasses.replace(ref, **HYBRID)
    return port, ref


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """JAX's loss, gradients and one ``apply_opt`` step, and the port's
    model, on one numpy weight tree: drawn by the port's ``init`` from seed
    0 and held to the names, shapes and dtypes of ``jax.eval_shape`` of the
    reference's ``init`` (JAX's own init takes 2.5 to 3.5 s a model to
    compile on a CPU).  rwkv6's bonus ``u`` is drawn nonzero, as
    ``tests/test_torch_rwkv6.py`` draws it, so the bonus term is exercised
    (both inits give zeros)."""
    cfg_port, cfg_jax = _configs(arch)
    jm = jax_get_model(cfg_jax)
    model = get_model(cfg_port, device="cpu")
    drawn = model.init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = jax.tree.unflatten(jax.tree.structure(shapes),
                              [t.numpy() for t in tree_leaves(drawn)])
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(tree)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(shapes)]
    if arch == "rwkv6-1.6b":
        u = tree["blocks"]["time_mix"]["u"]
        tree["blocks"]["time_mix"]["u"] = (np.random.default_rng(0)
                                           .standard_normal(u.shape) * 0.3
                                           ).astype(u.dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = jax_host_batch(JaxSyntheticLM(cfg_jax.vocab_size, SEQ, ROWS,
                                           seed=0), 0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch)
    apply_opt = jax.jit(functools.partial(jax_apply_opt,
                                          JaxAdamWConfig(lr=1e-3)))
    return dict(jparams=jparams, loss=loss, grads=grads, apply_opt=apply_opt,
                step=apply_opt(jparams, grads, jax_init_opt(jparams)),
                model=model, params=params_from_jax(tree, model),
                ds=SyntheticLM(cfg_port.vocab_size, SEQ, ROWS, seed=0))


def _mesh(shape, axes, seed=0):
    n = int(np.prod(shape))
    order = tuple(int(i) for i in np.random.default_rng(seed).permutation(n))
    return PlannedMesh(order=order, shape=shape, axis_names=axes,
                       device=torch.device("cpu"))


def _step(model, mesh):
    sizes = shd.mesh_axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in shd.dp_axes(mesh)]))
    reducer = None
    if dp > 1:
        reducer = OverlapGradReducer(certified_allreduce(dp, 1 << 16, "ring"),
                                     bucket_bytes=1 << 16, mode="bucketed",
                                     transport="runner")
    return make_sharded_train_step(model, AdamWConfig(lr=1e-3), mesh, reducer)


def _close(got, want, rtol, atol):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol, atol=atol)


def _reckon(cfg, m, dp):
    """Model-axis schedule runs of one step, from the specs' choices.

    A data-parallel rank's forward: the embedding's all-reduce; each
    sharded row-parallel output's all-reduce (rwkv6: the time mix's
    ``wo`` and the channel mix's ``wv``; the hybrid: the recurrent
    block's ``w_out`` or the attention's ``wo``, and each block's MLP
    ``w2``); the loss's gather of logz and its gold all-reduce.  Its
    backward: one all-reduce a conjugate identity (rwkv6's stacked
    k/v/r/g mixes, the channel mix's ``x_k``; the recurrent block's normed
    input, the attention's query input and, the one KV head whole, its k
    and v; every MLP's input; the head's) and, in rwkv6, the decay's
    all-gather a block (``split``'s backward).  The checkpoint recomputes
    up to the last tensor the backward saved: rwkv6's whole block (the
    channel mix's gate multiplies its all-reduced sum, so the sum is
    saved); a hybrid group but for its last MLP's all-reduce, which ends
    the group.  The tail is not checkpointed.  Then the clip's one
    all-reduce a step.
    """
    L = cfg.n_layers
    vocab, ff = cfg.vocab_size % m == 0, cfg.d_ff % m == 0
    heads, kv = cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0
    if cfg.family == "ssm":
        fwd = bwd = recompute = L * (heads + ff)
        gathers = L * heads
    else:
        chan = cfg.d_model % m == 0
        pattern = cfg.block_pattern
        groups, tail = divmod(L, len(pattern))

        def fwd_of(kinds):
            return sum((heads if k == "A" else chan) + ff for k in kinds)

        fwd = fwd_of(pattern * groups + pattern[:tail])
        bwd = sum((heads * (1 + 2 * (not kv)) if k == "A" else chan) + ff
                  for k in pattern * groups + pattern[:tail])
        recompute = groups * (fwd_of(pattern) - ff)
        gathers = 0
    per_rank = (vocab + fwd + vocab) + (bwd + vocab) + recompute
    return {"allreduce": dp * per_rank + 1, "allgather": dp * (gathers + vocab)}


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_and_grads_equal_the_reference(arch, shape, axes):
    s = _setup(arch)
    mesh = _mesh(shape, axes)
    step = _step(s["model"], mesh)
    lay = step.layout
    storage = shard_params(s["params"], lay.pspecs, lay.m)
    batch = make_global_batch(s["ds"], 0, mesh, shd.batch_spec(mesh))
    loss, grads = step.value_and_grad(storage, batch)
    np.testing.assert_allclose(float(loss), float(s["loss"]), rtol=1e-5)
    _close(unshard_params(grads, lay.pspecs), s["grads"], rtol=1e-4, atol=1e-5)
    # the specs shard what the reference's rules shard: on a model axis of
    # 2 every family's heads, channels, d_ff and vocabulary divide
    blocks = lay.pspecs["blocks" if arch == "rwkv6-1.6b" else "groups"]
    if arch == "rwkv6-1.6b":
        sharded = [blocks["time_mix"][k] for k in ("wr", "wk", "wv", "wg",
                                                   "wo", "u", "ln_x_w")]
        sharded += [blocks["channel_mix"][k] for k in ("wk", "wv")]
        whole = [blocks["time_mix"][k] for k in ("maa", "w0", "wA", "wB")]
        whole.append(blocks["channel_mix"]["wr"])
    else:
        rec, att = blocks["R0"], blocks["A2"]
        sharded = [rec[k] for k in ("w_gate", "w_in", "w_a", "w_x", "w_out",
                                    "conv_w", "conv_b", "b_a", "b_x", "lam")]
        sharded += [att["attn"]["wq"], att["attn"]["wo"], rec["mlp"]["w1"]]
        sharded += [b["w_in"] for b in lay.pspecs["tail"]]
        whole = [att["attn"]["wk"], att["attn"]["wv"], rec["norm"]]
    assert all(tpm.model_dim(p) is not None for p in sharded)
    assert all(tpm.model_dim(p) is None for p in whole)


def _unslice_tree(tree, lay):
    leaves = [t if z is None else _unslice(t, z)
              for t, z in zip(tree_leaves(tree), lay.zdims)]
    return tree_unflatten(tree, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_sharded_step_equals_the_reference_step(arch, monkeypatch):
    """On ``(2, 2)``: the clip, AdamW on each rank's ZeRO-1 slice and the
    all-gather give the reference's ``apply_opt`` on the port's
    gradients, and its parameters after a step on JAX's own gradients;
    every model-axis collective of the step runs a certified schedule, as
    many as :func:`_reckon` says."""
    s = _setup(arch)
    seen = []
    inner = tpm.run_schedule

    def spy(x, schedule, use_kernel_add=True):
        seen.append((schedule.postcondition, schedule.n, tuple(x.shape)))
        return inner(x, schedule, use_kernel_add)

    monkeypatch.setattr(tpm, "run_schedule", spy)
    mesh = _mesh((2, 2), ("data", "model"), seed=1)
    step = _step(s["model"], mesh)
    lay = step.layout
    state0 = init_sharded_state(s["model"], torch.Generator().manual_seed(0),
                                lay)
    state0 = state0._replace(params=shard_params(s["params"], lay.pspecs, lay.m))
    assert any(z is not None for z in lay.zdims)
    batch = make_global_batch(s["ds"], 0, mesh, shd.batch_spec(mesh))
    state, metrics = step(state0, batch)
    want = _reckon(s["model"].cfg, lay.m, lay.dp)
    got = {"allreduce": sum(p == "allreduce" for p, *_ in seen),
           "allgather": sum(p == "all_gather" for p, *_ in seen)}
    assert got == {"allreduce": want["allreduce"],
                   "allgather": want["allgather"] + 1}   # + ZeRO-1's, data axis
    assert step.counts == {"model_allreduce": want["allreduce"],
                           "model_allgather": want["allgather"],
                           "data_allgather": 1, "data_allreduce": 1}
    assert all(n == lay.m and x[0] == lay.m for p, n, x in seen
               if p == "allreduce")
    # the step's own gradients, again (the step writes new parameters and
    # updates the moments in place), for the reference's AdamW on them
    monkeypatch.setattr(tpm, "run_schedule", inner)
    _, grads = step.value_and_grad(state0.params, batch)
    params = unshard_params(state.params, lay.pspecs)
    moments = [unshard_params(_unslice_tree(tree, lay), lay.pspecs)
               for tree in (state.opt.m, state.opt.v)]
    jp = s["jparams"]
    g = jax.tree.unflatten(jax.tree.structure(jp), [
        t.numpy() for t in tree_leaves(unshard_params(grads, lay.pspecs))])
    ref_p, ref_opt, ref_m = s["apply_opt"](jp, g, jax_init_opt(jp))
    _close(params, ref_p, rtol=1e-4, atol=1e-5)
    _close(moments[0], ref_opt.m, rtol=1e-4, atol=1e-6)
    _close(moments[1], ref_opt.v, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-5)
    # against the reference's step on its own gradients: AdamW's first
    # update is lr x the gradient's sign, so a near-zero gradient rounded
    # across zero moves 2 lr apart (as the qwen case holds it)
    step_p, _, step_m = s["step"]
    _close(params, step_p, rtol=0, atol=2e-3)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(step_m["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["loss"]), float(s["loss"]),
                               rtol=1e-5)
    assert int(state.step) == 1 and int(state.opt.count) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_the_clip_counts_the_recurrent_leaves_once(arch):
    """On ``(1, 2)`` the clip's norm sums each sharded leaf's shards over
    the model ranks and counts a replicated one (the LoRAs, the norms,
    the MQA's k and v) once: the reference's ``grad_norm``."""
    s = _setup(arch)
    mesh = _mesh((1, 2), ("data", "model"))
    step = _step(s["model"], mesh)
    lay = step.layout
    _, grads = step.value_and_grad(
        shard_params(s["params"], lay.pspecs, lay.m),
        make_global_batch(s["ds"], 0, mesh, shd.batch_spec(mesh)))
    got = float(step.tp.global_norm(grads))
    np.testing.assert_allclose(got, float(s["step"][2]["grad_norm"]),
                               rtol=1e-5)
