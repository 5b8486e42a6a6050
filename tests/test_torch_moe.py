"""The port's MoE and MLA models against the JAX package's, on the same weights.

The smoke ``deepseek-v2-236b`` (MLA, one dense head layer and one MoE
layer of 4 experts top-2 with a shared expert) and ``dbrx-132b`` (GQA, two
MoE layers of 4 experts top-2), in f32, one numpy weight tree in the
layout and dtypes of JAX's ``init`` for both (drawing it with numpy costs
no JAX compile), carried to the port by ``params_from_jax``: ``forward``
logits and aux, ``loss`` and every
gradient, ``prefill`` and its cache tree, decode (deepseek naive and
matrix-absorbed) and the engine's greedy tokens; ``moe_dense``,
``moe_scatter`` and ``_router_probs`` one to one; the experts' init
scale; and the expert-parallel all-to-all (``repro_torch.parallel.
moe_a2a``): its shift rounds and its plan order against the reference's,
and on an 8-rank virtual mesh against ``moe_dense`` in values and
gradients.  Tolerances: f32 on both sides, the same math in another
order: atol 2e-4 / rtol 2e-3 on logits (``tests/test_models_smoke.py``'s
MoE tolerance), 1e-5 on the router's outputs and 1e-4 on gradients.
"""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.fabric as R_fab  # noqa: E402
import repro.plan as R_plan  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.parallel import moe_a2a as R_a2a  # noqa: E402
from repro.serve.engine import _grow_cache as jax_grow_cache  # noqa: E402
from repro.session.mixes import serve_mix as R_serve_mix  # noqa: E402
import repro_torch.fabric as T_fab  # noqa: E402
import repro_torch.plan as T_plan  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch.mesh import PlannedMesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.kernels.schedule_runner import check_postcondition  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.parallel import moe_a2a  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.session import serve_mix as T_serve_mix  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["deepseek-v2-236b", "dbrx-132b"]
BATCH, PROMPT, NEW = 2, 12, 3
LOGITS = dict(atol=2e-4, rtol=2e-3)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or LOGITS))


@pytest.fixture(autouse=True)
def _no_ep():
    """The EP state is module state: no test leaves it armed."""
    moe_a2a.clear_ep()
    yield
    moe_a2a.clear_ep()


def _numpy_tree(spec, seed: int):
    """Weights for both packages from the port's spec: each normal entry
    drawn by a seeded numpy generator at its init scale, constants filled."""
    rng = np.random.default_rng(seed)

    def draw(entry):
        shape, (kind, val) = entry[:2]
        if kind == "const":
            return np.full(shape, val, np.float32)
        scale = shape[-2] ** -0.5 if val is None else val
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return L.map_spec(spec, draw)


def _greedy(jm, params, toks, steps: int):
    """JAX's prefill, the cache grown by ``steps`` and ``steps`` greedy
    decode steps (one compile of each): (prefill logits, step logits,
    tokens, final cache, prefill cache)."""
    logits, first = jax.jit(jm.prefill)(params, toks)
    P = toks.shape[1]
    cache = jax_grow_cache(first, P, P + steps)
    step = jax.jit(jm.decode_step)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    outs, picked = [], [cur]
    for _ in range(steps):
        step_logits, cache = step(params, cur, cache)
        cur = jnp.argmax(step_logits, -1).astype(jnp.int32)
        outs.append(step_logits)
        picked.append(cur)
    return logits, jnp.stack(outs), jnp.stack(picked, 1), cache, first


@pytest.fixture(scope="module", params=ARCHS)
def side(request):
    """Both packages' model on one arch's smoke config with the same
    weights (a numpy tree in JAX's layout, checked against the shapes and
    dtypes of JAX's ``init``, carried to the port by ``params_from_jax``),
    a prompt, and JAX's forward and greedy decode of it."""
    arch = request.param
    # the layers unrolled: the scanned model's math, compiled faster
    jm = jax_get_model(dataclasses.replace(jax_get_config(arch).smoke(),
                                           use_scan=False))
    model = get_model(get_config(arch).smoke(), device="cpu")
    tree = _numpy_tree(model.param_spec(), seed=0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), shapes) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree)
    toks = np.random.default_rng(0).integers(1, jm.cfg.vocab_size,
                                             (BATCH, PROMPT)).astype(np.int32)
    jl, jaux = jax.jit(jm.forward)(tree, jnp.asarray(toks))
    greedy = _greedy(jm, tree, jnp.asarray(toks), NEW)
    return dict(arch=arch, jm=jm, tree=tree, model=model,
                params=params_from_jax(tree, model), toks=toks, jl=jl,
                jaux=jaux, greedy=greedy)


def test_forward_loss_and_grads_match_jax(side):
    """Logits and the summed aux of ``forward``, then ``loss`` (cross
    entropy + 0.01 x aux) and every leaf's gradient against ``jax.grad``."""
    model, toks = side["model"], torch.from_numpy(side["toks"]).long()
    with torch.no_grad():
        logits, aux = model.forward(side["params"], toks)
    _close(logits, side["jl"])
    _close(aux, side["jaux"], atol=1e-5, rtol=1e-5)
    batch = {"tokens": side["toks"][:, :-1], "labels": side["toks"][:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(side["jm"].loss))(
        side["tree"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.clone().requires_grad_(True), side["params"])
    loss = model.loss(params, {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss, atol=5e-5, rtol=5e-5)
    got = [t.grad for t in tree_leaves(params)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) and all(g is not None for g in got)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_prefill_and_cache_tree_match_jax(side):
    """The last position's logits and every cache leaf: k/v for dbrx, the
    latents ``ckv``/``k_rope`` under ``"head"`` and ``"scan"`` for
    deepseek; ``init_cache`` gives JAX's tree, shapes and dtypes."""
    model = side["model"]
    logits, cache = model.prefill(side["params"], torch.from_numpy(side["toks"]))
    _close(logits, side["greedy"][0])
    jc = side["greedy"][4]
    assert set(cache) == set(jc)
    for where in set(jc) - {"pos"}:
        assert set(cache[where]) == set(jc[where])
        for name in jc[where]:
            _close(cache[where][name], jc[where][name], atol=2e-5, rtol=2e-5)
    assert int(cache["pos"]) == int(jc["pos"]) == PROMPT
    empty = model.init_cache(3, 20)
    jempty = jax.eval_shape(lambda: side["jm"].init_cache(3, 20))
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                    empty) == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jempty)
    want = ({"head", "scan", "pos"}, {"ckv", "k_rope"}) \
        if side["arch"] == "deepseek-v2-236b" else ({"scan", "pos"}, {"k", "v"})
    assert set(empty) == want[0] and set(empty["scan"]) == want[1]


def test_decode_steps_match_jax(side):
    """Greedy decode steps from the grown prefill cache, each step's logits
    and argmax and the final cache; deepseek also matrix-absorbed
    (``mla_absorb``, the full config's choice; the smoke config's default
    is the naive decode)."""
    absorbs = [False, True] if side["arch"] == "deepseek-v2-236b" else [False]
    for absorb in absorbs:
        model = DecoderLM(dataclasses.replace(side["model"].cfg,
                                              mla_absorb=absorb), device="cpu")
        if absorb:
            jm = jax_get_model(dataclasses.replace(side["jm"].cfg, mla_absorb=True))
            _, jsteps, jtoks, jcache, _ = _greedy(
                jm, side["tree"], jnp.asarray(side["toks"]), NEW)
        else:
            _, jsteps, jtoks, jcache, _ = side["greedy"]
        logits, cache = model.prefill(side["params"], torch.from_numpy(side["toks"]))
        cache = engine_mod._grow_cache(cache, PROMPT, PROMPT + NEW)
        cur = logits.argmax(-1)
        for i in range(NEW):
            assert cur.tolist() == np.asarray(jtoks[:, i]).tolist()
            logits, cache = model.decode_step(side["params"], cur, cache)
            _close(logits, jsteps[i])
            cur = logits.argmax(-1)
        for where in set(jcache) - {"pos"}:
            for name in jcache[where]:
                _close(cache[where][name], jcache[where][name],
                       atol=2e-5, rtol=2e-5)
        assert int(cache["pos"]) == int(jcache["pos"]) == PROMPT + NEW


def test_greedy_tokens_equal_jax_engine(side):
    """The engine's tokens (eos=-1, so no trimming can hide a mismatch)
    equal JAX's greedy prefill and decode steps, which the reference's
    engine runs; the engine grows the latent or k/v caches, deepseek's
    ``"head"`` sub-tree included."""
    got = GenerationEngine(side["model"], side["params"],
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1)
                           ).generate(side["toks"].tolist())
    assert got == np.asarray(side["greedy"][2][:, :NEW]).tolist()
    assert all(len(row) == NEW for row in got)


@pytest.fixture(scope="module")
def moe_side():
    """One MoE layer of the smoke deepseek (a shared expert) in groups of 8,
    drawn by the reference's ``init_moe``, on random activations ``[2, 16,
    D]``, and JAX's ``_router_probs``, ``moe_dense`` and ``moe_scatter``
    of them (one compile)."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").smoke(),
                              moe_group_size=8)
    jcfg = dataclasses.replace(jax_get_config("deepseek-v2-236b").smoke(),
                               moe_group_size=8)
    jp = jax.jit(lambda k: JL.init_moe(k, jcfg, jnp.float32))(jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    fns = ("_router_probs", "moe_dense", "moe_scatter")
    want = jax.jit(lambda p, x: {f: getattr(JL, f)(p, x, jcfg) for f in fns})(
        jp, jnp.asarray(x))
    tree = jax.tree.map(np.asarray, jp)
    p = params_from_jax(tree, SimpleNamespace(param_spec=lambda: L.moe_spec(cfg),
                                              device="cpu"))
    return dict(cfg=cfg, tree=tree, p=p, x=x, want=want)


@pytest.mark.parametrize("fn", ["_router_probs", "moe_dense", "moe_scatter"])
def test_moe_functions_match_jax(moe_side, fn):
    """The router's top-k, weights and aux; the dense dispatch (two groups
    a row, capacity drops at the published 1.25) and the sorted scatter."""
    got = getattr(L, fn)(moe_side["p"], torch.from_numpy(moe_side["x"]),
                         moe_side["cfg"])
    want = moe_side["want"][fn]
    if fn == "_router_probs":
        assert got[0].tolist() == np.asarray(want[0]).tolist()
        _close(got[1], want[1], atol=1e-5, rtol=1e-5)
        _close(got[2], want[2], atol=1e-5, rtol=1e-5)
    else:
        _close(got[0], want[0], atol=2e-5, rtol=2e-5)
        _close(got[1], want[1], atol=1e-5, rtol=1e-5)


def test_expert_init_scale_is_the_references(moe_side):
    """The port draws the expert weights at the reference's ``1/sqrt(E)``
    (its ``dense_init`` default on ``[E, d, fe]``; the fan-in d would give
    a quarter of it here), the shared expert at its fan-in, and the router
    at 0.02 and in f32 in a bf16 model: each tensor's standard deviation
    within 5 % of the reference's draw."""
    cfg = dataclasses.replace(moe_side["cfg"], dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = get_model(cfg, device="cpu").init(gen)["blocks"]["moe"]
    ref = moe_side["tree"]
    for path in (("router",), ("w1",), ("w3",), ("w2",), ("shared", "w1"),
                 ("shared", "w2")):
        got, want = params, ref
        for k in path:
            got, want = got[k], want[k]
        assert got.shape[1:] == want.shape, path
        assert abs(got.float().std().item() / want.std() - 1) < 0.05, path
    assert params["router"].dtype == torch.float32
    assert params["w1"].dtype == torch.bfloat16
    assert abs(ref["w1"].std() * cfg.n_experts ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("n,order", [(4, None), (4, (2, 0, 3, 1)),
                                     (8, None), (8, (3, 1, 4, 0, 6, 2, 7, 5))])
def test_shift_perms_equal_the_references(n, order):
    assert moe_a2a._shift_perms(n, order) == R_a2a._shift_perms(n, order)


def test_arm_ep_order_from_a_plan_equals_the_references():
    """On the same probe and serving mix (the EP all-to-all over 8 nodes),
    with a planned ``(8,)`` data mesh and without a mesh plan, the armed
    shift order is the reference's (``tests/test_plan.py``'s counterpart);
    without a plan it stays the identity (None)."""
    fab = R_fab.make_datacenter(8, nodes_per_rack=2, racks_per_agg=2, seed=4)
    probe = R_fab.probe_fabric(fab, seed=1)
    tprobe = T_fab.ProbeResult(lat=probe.lat, bw=probe.bw, n_probes=probe.n_probes,
                               percentile=probe.percentile)
    budget = dict(iters=10, chains=1)
    rmesh = SimpleNamespace(axis_names=("data",), devices=np.zeros((8,)))
    tmesh = make_mesh((8,), ("data",), device="cpu")
    orders = []
    for kw in (dict(mesh_shape=(8,), axis_names=("data",)), {}):
        r = R_plan.PlanCompiler(budget=R_plan.SolveBudget(**budget), seed=0).compile(
            probe, R_serve_mix(1e6, moe=True), **kw)
        t = T_plan.PlanCompiler(budget=T_plan.SolveBudget(**budget), seed=0).compile(
            tprobe, T_serve_mix(1e6, moe=True), **kw)
        R_a2a.arm_ep(rmesh, "data", None, plan=r)
        moe_a2a.arm_ep(tmesh, "data", None, plan=t)
        want = R_a2a._EP_STATE["a2a_order"]
        R_a2a.clear_ep()
        assert want is not None and moe_a2a._EP_STATE["a2a_order"] == want
        orders.append(want)
    assert orders[0] != tuple(range(8))
    moe_a2a.arm_ep(tmesh, "data", None)
    assert moe_a2a._EP_STATE["a2a_order"] is None


def test_moe_a2a_matches_dense_on_the_virtual_mesh():
    """8 EP ranks, 8 experts top-2 at capacity factor 8 (nothing drops),
    one row a rank, in a scrambled shift order: the armed model's logits
    and every gradient equal the dense dispatch's
    (``tests/test_perf_opts.py``'s check, without its subprocess); each
    layer call makes two certified all-to-all runs of 3 (the dispatch of
    tokens and of expert ids, the return trip) and records two."""
    cfg = dataclasses.replace(get_config("dbrx-132b").smoke(), n_experts=8,
                              moe_top_k=2, capacity_factor=8.0)
    model = get_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 16)))

    def run():
        ps = tree_map(lambda t: t.clone().requires_grad_(True), params)
        logits, _ = model.forward(ps, toks)
        (logits.float() ** 2).mean().backward()
        return logits.detach(), [t.grad for t in tree_leaves(ps)]

    ld, gd = run()
    moe_a2a.arm_ep(make_mesh((8,), ("data",), device="cpu"), "data", None)
    order = (3, 1, 4, 0, 6, 2, 7, 5)
    moe_a2a._EP_STATE["a2a_order"] = order
    assert moe_a2a.ep_armed(cfg)
    la, ga = run()
    torch.testing.assert_close(la, ld, atol=2e-5, rtol=2e-5)
    for a, d in zip(ga, gd):
        torch.testing.assert_close(a, d, atol=1e-6, rtol=1e-4)

    rec = obs.recorder()
    was, before = rec.enabled, rec.captured
    runs = []
    real = moe_a2a.schedule_runner.run_schedule

    def spy(x, sched):
        out = real(x, sched)
        runs.append(check_postcondition(sched, x, out))
        return out

    rec.enabled = True
    moe_a2a.schedule_runner.run_schedule = spy
    try:
        with torch.no_grad():
            model.forward(params, toks)
        records = rec.trace().records
        ops = [r.op for r in records[len(records) - (rec.captured - before):]]
    finally:
        moe_a2a.schedule_runner.run_schedule = real
        rec.enabled = was
    assert runs == [[]] * 3 * cfg.n_layers
    assert ops == ["all-to-all"] * 2 * cfg.n_layers
    assert moe_a2a._lowered_a2a(8, order).shift_rounds == tuple(
        tuple(r) for r in R_a2a._shift_perms(8, order))


def test_ep_refuses_a_group_backed_mesh_and_a_second_axis():
    """A group-backed mesh arms (its path runs forward and backward in
    ``tests/test_torch_group.py``'s spawn).  Of the second axes, a model
    axis is taken: the layer on a ``(2, 2)`` mesh, its weights whole on
    every model rank, gives ``moe_dense``'s output at the capacity factor
    E/K (``tests/test_torch_moe_train.py`` holds the sharded layer and its
    gradients).  A pod axis is refused naming item 24 (the experts'
    gradients need a pod-axis all-reduce), any other axis in words."""
    from repro_torch.parallel.tensor import TensorParallel

    group_mesh = PlannedMesh(order=tuple(range(8)), shape=(8,), axis_names=("data",),
                             device=torch.device("cpu"), group=object())
    moe_a2a.arm_ep(group_mesh)
    gcfg = dataclasses.replace(get_config("dbrx-132b").smoke(), n_experts=8)
    assert moe_a2a.ep_armed(gcfg) and moe_a2a._EP_STATE["mesh"] is group_mesh
    cfg = dataclasses.replace(get_config("dbrx-132b").smoke(), n_experts=4,
                              capacity_factor=2.0)
    p = L.init_from_spec(torch.Generator().manual_seed(0), L.moe_spec(cfg),
                         torch.float32)
    x = torch.randn(2, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for shape, axes, match in (((2, 2, 1), ("pod", "data", "model"), "item 24"),
                               ((2, 2), ("data", "stage"), "a model axis only")):
        moe_a2a.arm_ep(make_mesh(shape, axes, device="cpu"))
        with pytest.raises(NotImplementedError, match=match):
            L.moe_layer(p, x, cfg)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    moe_a2a.arm_ep(mesh)
    assert moe_a2a._EP_STATE["tp"] == "model"
    y, _ = L.moe_layer(p, x, cfg, tp=TensorParallel(mesh, None))
    torch.testing.assert_close(y, L.moe_dense(p, x, cfg)[0], atol=1e-5,
                               rtol=1e-5)
