"""The port's hybrid model (RG-LRU + local attention) against the JAX package's.

The smoke ``recurrentgemma-9b`` (f32, window 32, MQA, head width 16) with
5 layers, so one (R, R, A) group and a tail of two recurrent blocks; JAX's
``init`` carried across by ``params_from_jax``.  Tolerances: f32 on both
sides, the same math in another order (the port's doubling scan for the
reference's step-by-step ``lax.scan``), so atol/rtol 1e-5 on the
recurrence, 2e-5 on logits and caches, 5e-5 on the loss and 1e-4 on its
gradients; greedy tokens are equal.
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
from repro.models.rglru import rglru_recurrence as jax_rglru  # noqa: E402
from repro.serve.engine import _grow_cache as jax_grow_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.rglru import RecurrentGemmaLM, rglru_recurrence  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH, N_LAYERS, BATCH, NEW = "recurrentgemma-9b", 5, 2, 3
TOL = dict(atol=2e-5, rtol=2e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cfgs(impl="xla", n_layers=N_LAYERS):
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), n_layers=n_layers)
    cfg = dataclasses.replace(get_config(ARCH).smoke(), n_layers=n_layers,
                              attention_impl=impl)
    return jcfg, cfg


@pytest.fixture(scope="module")
def side():
    """Both packages' model and weights, and the jitted JAX serving steps."""
    jcfg, _ = _cfgs()
    jm = jax_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    models = {impl: get_model(_cfgs(impl)[1], device="cpu")
              for impl in ("xla", "flash")}
    return dict(jm=jm, jparams=jparams, tree=tree, models=models,
                params=params_from_jax(tree, models["xla"]),
                jprefill=jax.jit(jm.prefill), jdecode=jax.jit(jm.decode_step))


def _tokens(P, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (BATCH, P)).astype(np.int32)


@pytest.mark.parametrize("S,h0", [(24, False), (24, True), (512, True)],
                         ids=["fresh", "h0", "segmented"])
def test_rglru_recurrence_matches_jax(S, h0):
    """S = 512 runs both sides' 256-token segments (the reference's
    checkpointed scan; the port's doubling scan over two segments)."""
    rng = np.random.default_rng(S + h0)
    B, D = 2, 8
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    r = (1 / (1 + np.exp(-rng.standard_normal((B, S, D))))).astype(np.float32)
    i = (1 / (1 + np.exp(-rng.standard_normal((B, S, D))))).astype(np.float32)
    lam = np.log1p(np.exp(rng.uniform(-3, 1, D))).astype(np.float32)
    h = rng.standard_normal((B, D)).astype(np.float32) if h0 else None
    # the reference's h0=None is zeros: passing them shares one compile
    wy, wh = jax_rglru(*(jnp.asarray(a) for a in (x, r, i, lam)),
                       jnp.zeros((B, D)) if h is None else jnp.asarray(h))
    gy, gh = rglru_recurrence(*(torch.from_numpy(a) for a in (x, r, i, lam)),
                              None if h is None else torch.from_numpy(h))
    _close(gy, wy, atol=1e-5, rtol=1e-5)
    _close(gh, wh, atol=1e-5, rtol=1e-5)
    assert gy.dtype == torch.float32 and gh.dtype == torch.float32


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_logits_and_cache_match_jax(side, impl):
    """P = 40 > W = 32: the ring roll and the window mask both run."""
    toks = _tokens(40)
    jl, jc = side["jprefill"](side["jparams"], jnp.asarray(toks))
    tl, tc = side["models"][impl].prefill(side["params"], torch.from_numpy(toks))
    _close(tl, jl)
    assert set(tc) == set(jc) == {"groups", "pos", "tail_h", "tail_conv"}
    assert set(tc["groups"]) == set(jc["groups"]) == {"h", "conv", "k", "v"}
    for name in ("h", "conv", "k", "v"):
        assert tuple(tc["groups"][name].shape) == jc["groups"][name].shape
        _close(tc["groups"][name], jc["groups"][name])
    for name in ("tail_h", "tail_conv"):
        _close(tc[name], jc[name])
    assert int(tc["pos"]) == int(jc["pos"]) == 40


def test_init_cache_tree_matches_jax(side):
    got = side["models"]["xla"].init_cache(3, 64)
    want = jax.eval_shape(lambda: side["jm"].init_cache(3, 64))
    flat_g = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(w.shape) for _, w in flat_g]
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(got)] == \
        [str(w.dtype) for _, w in flat_g]
    assert not any(bool(t.any()) for t in tree_leaves(got))   # zeros, as JAX's


@pytest.mark.parametrize("P", [20, 40], ids=["P<W", "P>W"])
def test_decode_and_greedy_tokens_match_jax(side, P):
    """Three decode steps' logits, greedy tokens and caches from the same
    prefill; the engine's greedy tokens (eos=-1, nothing trimmed) equal
    them."""
    toks = _tokens(P, seed=P)
    model = side["models"]["flash"]
    jl, jc = side["jprefill"](side["jparams"], jnp.asarray(toks))
    tl, tc = model.prefill(side["params"], torch.from_numpy(toks))
    want = []
    for _ in range(NEW):
        cur = tl.argmax(-1)
        assert cur.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()
        want.append(cur.tolist())
        jl, jc = side["jdecode"](side["jparams"], jnp.asarray(cur.numpy(), jnp.int32), jc)
        tl, tc = model.decode_step(side["params"], cur, tc)
        _close(tl, jl)
    for name in ("h", "conv", "k", "v"):
        _close(tc["groups"][name], jc["groups"][name])
    assert int(tc["pos"]) == int(jc["pos"]) == P + NEW
    got = GenerationEngine(model, side["params"], GenerationConfig(
        max_new_tokens=NEW, eos_token=-1)).generate(toks.tolist())
    assert got == [list(row) for row in zip(*want)]


def test_prompt_as_long_as_the_window_serves(side):
    """P == W: the reference's engine pads the ring buffer (its
    ``_grow_cache`` takes a W-slot ring for a P-long prompt cache) and its
    decode then fails; the port's engine leaves the ring alone, and its
    tokens equal the reference's ``prefill`` + ``decode_step`` driven by
    hand."""
    W = side["jm"].cfg.attn_window
    toks = _tokens(W, seed=7)
    prompts = toks.tolist()
    jl, jc = side["jprefill"](side["jparams"], jnp.asarray(toks))
    padded = jax_grow_cache(jc, W, W + NEW)      # what the reference's engine does
    assert padded["groups"]["k"].shape[-2] == W + NEW
    with pytest.raises(ValueError, match="Incompatible shapes"):
        side["jdecode"](side["jparams"], jnp.argmax(jl, -1).astype(jnp.int32), padded)
    want = []
    for _ in range(NEW):
        cur = jnp.argmax(jl, -1).astype(jnp.int32)
        want.append(np.asarray(cur).tolist())
        jl, jc = side["jdecode"](side["jparams"], cur, jc)
    want = [list(row) for row in zip(*want)]
    grown = []
    model = side["models"]["flash"]
    real = model.grow_cache

    def spy(cache, cur_len, new_len):
        out = real(cache, cur_len, new_len)
        grown.append(tuple(out["groups"]["k"].shape))
        return out

    eng = GenerationEngine(model, side["params"],
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1))
    model.grow_cache = spy
    try:
        got = eng.generate(prompts)
    finally:
        del model.grow_cache
    assert got == want
    assert grown and grown[0][-2] == W


def test_loss_and_grads_match_jax():
    """``loss`` and every parameter's gradient against ``jax.grad`` (S = 40,
    so the window masks; no loss chunking at this length), on the 3-layer
    smoke config: one group, whose blocks the tail repeats."""
    jcfg, cfg = _cfgs(n_layers=3)
    # the layers unrolled: the same math as the scanned model, compiled faster
    jm = jax_get_model(dataclasses.replace(jcfg, use_scan=False))
    jparams = jm.init(jax.random.PRNGKey(1))
    model = get_model(cfg, device="cpu")
    toks = _tokens(41, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.clone().requires_grad_(True),
                      params_from_jax(jax.tree.map(np.asarray, jparams), model))
    loss = model.loss(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss, atol=5e-5, rtol=5e-5)
    got = [t.grad for t in tree_leaves(params)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_params_from_jax_checks_the_tail_list(side):
    model = side["models"]["xla"]
    assert isinstance(model, RecurrentGemmaLM)
    assert [tuple(t.shape) for t in tree_leaves(side["params"])] == \
        [np.shape(a) for a in jax.tree_util.tree_leaves(side["tree"])]
    tree = dict(side["tree"], tail=side["tree"]["tail"][:1])
    with pytest.raises(KeyError, match="tail"):
        params_from_jax(tree, model)
    bad = [dict(b) for b in side["tree"]["tail"]]
    bad[1]["w_out"] = bad[1]["w_out"][:, :3]
    with pytest.raises(ValueError, match=r"tail\[1\]/w_out"):
        params_from_jax(dict(side["tree"], tail=bad), model)
    bad = [dict(b) for b in side["tree"]["tail"]]
    del bad[0]["lam"]
    with pytest.raises(KeyError, match="lam"):
        params_from_jax(dict(side["tree"], tail=bad), model)
