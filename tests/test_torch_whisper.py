"""The port's Whisper (encoder/decoder) against the JAX package's, on the same weights.

The smoke ``whisper-small`` (f32: 2 encoder and 2 decoder layers, d 64,
4 heads of 16 on 2 kv heads, 16 audio frames), JAX's ``init`` carried
across by ``params_from_jax``, the audio stub random frames from a seeded
numpy generator.  Tolerances: f32 on both sides, the same math in another
order, so atol/rtol 2e-5 on the encoder states, logits and caches, 5e-5
on the loss and 1e-4 on its gradients; greedy tokens are equal.
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
from repro.serve.engine import _grow_cache as jax_grow_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH, BATCH, PROMPT, NEW = "whisper-small", 2, 12, 3
TOL = dict(atol=2e-5, rtol=2e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def side():
    jm = jax_get_model(jax_get_config(ARCH).smoke())
    jparams = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config(ARCH).smoke()
    models = {impl: get_model(dataclasses.replace(cfg, attention_impl=impl),
                              device="cpu") for impl in ("xla", "flash")}
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((BATCH, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    # one compile for the prefill and the encoder states it starts from
    (jl, jc), jenc = jax.jit(lambda p, t, a: (jm.prefill(p, t, a), jm.encode(p, a)))(
        jparams, jnp.asarray(toks), jnp.asarray(audio))
    return dict(jm=jm, jparams=jparams, tree=tree, models=models, audio=audio,
                toks=toks, jl=jl, jc=jc, jenc=jenc,
                params=params_from_jax(tree, models["xla"]))


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_encode_matches_jax(side, impl):
    """The encoder's unmasked self-attention on the flash path (its plain
    version on the CPU) and the plain one, against ``encode``."""
    with torch.no_grad():
        got = side["models"][impl].encode(side["params"],
                                          torch.from_numpy(side["audio"]))
    _close(got, side["jenc"])


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_matches_jax(side, impl):
    tl, tc = side["models"][impl].prefill(side["params"],
                                          torch.from_numpy(side["toks"]),
                                          torch.from_numpy(side["audio"]))
    _close(tl, side["jl"])
    assert set(tc) == set(side["jc"]) == {"k", "v", "xk", "xv", "pos"}
    for name in ("k", "v", "xk", "xv"):
        assert tuple(tc[name].shape) == side["jc"][name].shape
        _close(tc[name], side["jc"][name])
    assert int(tc["pos"]) == PROMPT


def test_decode_and_greedy_tokens_match_jax(side):
    """Three decode steps from the grown prefill cache (self k/v grown,
    cross k/v untouched on both sides), then the engine's greedy tokens
    with the audio as ``frontend_embeds``."""
    model = side["models"]["flash"]
    tl, tc = model.prefill(side["params"], torch.from_numpy(side["toks"]),
                           torch.from_numpy(side["audio"]))
    tc = engine_mod._grow_cache(tc, PROMPT, PROMPT + NEW)
    jc = jax_grow_cache(side["jc"], PROMPT, PROMPT + NEW)
    for name in ("k", "v", "xk", "xv"):
        assert tuple(tc[name].shape) == jc[name].shape
    jl, jdecode = side["jl"], jax.jit(side["jm"].decode_step)
    want = []
    for _ in range(NEW):
        cur = tl.argmax(-1)
        assert cur.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()
        want.append(cur.tolist())
        jl, jc = jdecode(side["jparams"], jnp.asarray(cur.numpy(), jnp.int32), jc)
        tl, tc = model.decode_step(side["params"], cur, tc)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    assert int(tc["pos"]) == int(jc["pos"]) == PROMPT + NEW
    got = GenerationEngine(model, side["params"], GenerationConfig(
        max_new_tokens=NEW, eos_token=-1)).generate(
            side["toks"].tolist(), frontend_embeds=torch.from_numpy(side["audio"]))
    assert got == [list(row) for row in zip(*want)]


def test_loss_and_grads_match_jax(side):
    """``loss`` (the batch carries the audio as ``frontend_embeds``) and
    every parameter's gradient against ``jax.grad``."""
    toks = np.random.default_rng(5).integers(1, 256, (BATCH, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frontend_embeds": side["audio"]}
    jloss, jgrads = jax.jit(jax.value_and_grad(side["jm"].loss))(
        side["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.clone().requires_grad_(True), side["params"])
    loss = side["models"]["xla"].loss(params, {
        "tokens": torch.from_numpy(batch["tokens"]).long(),
        "labels": torch.from_numpy(batch["labels"]).long(),
        "frontend_embeds": torch.from_numpy(side["audio"])})
    loss.backward()
    _close(loss, jloss, atol=5e-5, rtol=5e-5)
    got = [t.grad for t in tree_leaves(params)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


#: the port's bf16 prefill on f32 frames against the reference's on the
#: frames cast to bf16: readings 0.0039 to 0.0049 on logits of scale 0.45
#: to 0.65 over six seeds (about two bf16 steps), the limit four steps
BF16_LOGIT_BOUND = 0.015


def test_bf16_prefill_on_f32_frames_is_the_references_on_bf16_frames(side):
    """The port's one departure for Whisper in bf16, pinned: on the f32
    frames of the front-end stub the reference raises (its encoder
    promotes to f32 and the decoder scan's carry changes type), where the
    port casts the frames to the model's dtype; its prefill then equals
    the reference's on frames cast to bf16 within ``BF16_LOGIT_BOUND``."""
    jm = jax_get_model(dataclasses.replace(jax_get_config(ARCH).smoke(),
                                           dtype="bfloat16"))
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), side["jparams"])
    toks = jnp.asarray(side["toks"])
    with pytest.raises(TypeError, match="carry input and carry output must "
                                        "have equal types"):
        jax.jit(jm.prefill)(jparams, toks, jnp.asarray(side["audio"]))
    want, _ = jax.jit(jm.prefill)(jparams, toks,
                                  jnp.asarray(side["audio"], jnp.bfloat16))
    model = get_model(dataclasses.replace(get_config(ARCH).smoke(),
                                          dtype="bfloat16"), device="cpu")
    got, _ = model.prefill(params_from_jax(jax.tree.map(np.asarray, jparams), model),
                           torch.from_numpy(side["toks"]),
                           torch.from_numpy(side["audio"]))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert diff <= BF16_LOGIT_BOUND, diff


def test_params_from_jax_walks_the_nested_norms(side):
    model = side["models"]["xla"]
    assert isinstance(model, WhisperLM)
    assert [tuple(t.shape) for t in tree_leaves(side["params"])] == \
        [np.shape(a) for a in jax.tree_util.tree_leaves(side["tree"])]
    bad = dict(side["tree"], enc_ln={"w": side["tree"]["enc_ln"]["w"]})
    with pytest.raises(KeyError, match=r"enc_ln: missing \['b'\]"):
        params_from_jax(bad, model)


def test_grow_cache_leaves_cross_and_window_caches_alone():
    """Whisper's ``xk``/``xv`` stay at the audio context and the hybrid's
    ring buffers at the window, also when the prompt is exactly that long
    (the reference's engine pads the hybrid's ring there)."""
    cfg = get_config(ARCH).smoke()
    A = cfg.n_audio_ctx
    cache = get_model(cfg, device="cpu").init_cache(2, A)
    grown = engine_mod._grow_cache(cache, A, A + 4)
    assert grown["k"].shape[-2] == grown["v"].shape[-2] == A + 4
    assert grown["xk"] is cache["xk"] and grown["xv"] is cache["xv"]
    hybrid = get_model(get_config("recurrentgemma-9b").smoke(), device="cpu")
    W = hybrid.cfg.attn_window
    cache = hybrid.init_cache(2, W)
    assert hybrid.grow_cache(cache, W, W + 4)["groups"] is cache["groups"]
