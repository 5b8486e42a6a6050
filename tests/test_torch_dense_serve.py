"""The port's dense serving path against the JAX package's, on the same weights.

The smoke ``qwen2-0.5b`` and ``glm4-9b`` configs (f32, JAX's ``init``
carried across by ``params_from_jax``): ``init_cache``, ``prefill``,
``decode_step`` and the engine's greedy tokens, with the prefill's
attention through the flash path (its plain version on the CPU) and the
plain ``"xla"`` path; and the smoke ``llava-next-mistral-7b`` (the same
decoder behind the anyres stub) prefilled with image embeddings.  Tolerances: f32 on both sides, the same math in
another summation order, so atol/rtol 2e-5 on logits and caches.
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
from repro.serve import GenerationConfig as JaxGenerationConfig  # noqa: E402
from repro.serve import GenerationEngine as JaxGenerationEngine  # noqa: E402
from repro.serve.engine import _grow_cache as jax_grow_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

ARCHS = ["qwen2-0.5b", "glm4-9b"]
BATCH, PROMPT, NEW = 2, 12, 4
ATOL = RTOL = 2e-5


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module", params=ARCHS)
def side(request):
    """Both packages' model, weights and prefill on one arch's smoke config."""
    arch = request.param
    jm = jax_get_model(jax_get_config(arch).smoke())
    jparams = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    toks = np.random.default_rng(0).integers(1, jm.cfg.vocab_size, (BATCH, PROMPT))
    jlogits, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(toks))
    models = {impl: get_model(dataclasses.replace(get_config(arch).smoke(),
                                                  attention_impl=impl), device="cpu")
              for impl in ("xla", "flash")}
    params = params_from_jax(tree, models["flash"])
    return dict(arch=arch, jm=jm, jparams=jparams, tree=tree, toks=toks,
                jlogits=jlogits, jcache=jcache, models=models, params=params)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_matches_jax(side, impl):
    logits, cache = side["models"][impl].prefill(side["params"],
                                                 torch.from_numpy(side["toks"]))
    _close(logits, side["jlogits"])
    for name in ("k", "v"):
        _close(cache["scan"][name], side["jcache"]["scan"][name])
    assert int(cache["pos"]) == int(side["jcache"]["pos"]) == PROMPT


def test_flash_prefill_equals_xla_prefill(side):
    toks = torch.from_numpy(side["toks"])
    la, ca = side["models"]["flash"].prefill(side["params"], toks)
    lb, cb = side["models"]["xla"].prefill(side["params"], toks)
    torch.testing.assert_close(la, lb, atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        # layer 0 sees the same input on both paths; later layers see the
        # attention outputs, equal within the tolerance
        assert torch.equal(ca["scan"][name][0], cb["scan"][name][0])
        torch.testing.assert_close(ca["scan"][name], cb["scan"][name],
                                   atol=ATOL, rtol=RTOL)


def test_decode_steps_match_jax(side):
    model, jm = side["models"]["flash"], side["jm"]
    logits, cache = model.prefill(side["params"], torch.from_numpy(side["toks"]))
    cache = engine_mod._grow_cache(cache, PROMPT, PROMPT + 4)
    jcache = jax_grow_cache(side["jcache"], PROMPT, PROMPT + 4)
    jstep = jax.jit(jm.decode_step)
    cur = logits.argmax(-1)
    for _ in range(4):
        logits, cache = model.decode_step(side["params"], cur, cache)
        jlogits, jcache = jstep(side["jparams"], jnp.asarray(cur.numpy(), jnp.int32),
                                jcache)
        _close(logits, jlogits)
        cur = logits.argmax(-1)
        assert cur.tolist() == np.asarray(jnp.argmax(jlogits, -1)).tolist()
    for name in ("k", "v"):
        _close(cache["scan"][name], jcache["scan"][name])
    assert int(cache["pos"]) == int(jcache["pos"]) == PROMPT + 4


def test_init_cache_tree_matches_jax(side):
    got = side["models"]["flash"].init_cache(3, 20)
    want = side["jm"].init_cache(3, 20)
    assert set(got) == set(want) == {"scan", "pos"}
    assert set(got["scan"]) == set(want["scan"]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got["scan"][name].shape) == want["scan"][name].shape
        assert str(got["scan"][name].dtype).split(".")[-1] == \
            str(want["scan"][name].dtype)
        assert not got["scan"][name].any()
    assert got["pos"].dim() == 0 and int(got["pos"]) == 0
    assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_greedy_tokens_equal_jax_engine(side, impl, monkeypatch):
    """eos=-1, so no trimming can hide a mismatch; the engine grows the
    prefill's k/v to the wave's decode headroom through ``_grow_cache``."""
    prompts = side["toks"].tolist()
    expect = JaxGenerationEngine(
        side["jm"], side["jparams"],
        JaxGenerationConfig(max_new_tokens=NEW, eos_token=-1)).generate(prompts)
    grown = []
    real = engine_mod._grow_cache

    def spy(cache, cur_len, new_len):
        out = real(cache, cur_len, new_len)
        grown.append((tuple(cache["scan"]["k"].shape), tuple(out["scan"]["k"].shape),
                      tuple(out["scan"]["v"].shape)))
        return out

    monkeypatch.setattr(engine_mod, "_grow_cache", spy)
    eng = GenerationEngine(side["models"][impl], side["params"],
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1))
    got = eng.generate(prompts)
    assert got == expect and all(len(row) == NEW for row in got)
    cfg = side["models"][impl].cfg
    full = (cfg.n_layers, BATCH, cfg.n_kv_heads, PROMPT + NEW, cfg.head_dim)
    assert grown == [(full[:3] + (PROMPT,) + full[4:], full, full)]
    assert eng.stats["decode_steps"] == NEW


def test_flash_with_grad_enabled_raises(side):
    model = side["models"]["flash"]
    toks = torch.from_numpy(side["toks"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.forward(side["params"], toks)
    with pytest.raises(NotImplementedError, match="forward-only"):
        model.loss(side["params"], {"tokens": toks, "labels": toks})
    with torch.no_grad():
        logits, _ = model.forward(side["params"], toks)
    assert tuple(logits.shape) == (BATCH, PROMPT, model.cfg.vocab_size)


def test_windowed_decode_is_refused():
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), attn_window=8)
    model = get_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    with pytest.raises(NotImplementedError, match="hybrid"):
        model.decode_step(params, torch.zeros(1, dtype=torch.long),
                          model.init_cache(1, 4))


def test_params_from_jax_carries_an_untied_head_and_qkv_biases():
    """glm4-9b: untied ``lm_head`` and ``bq``/``bk``/``bv`` (the first
    untied dense tree the converter meets); a missing head raises."""
    jm = jax_get_model(jax_get_config("glm4-9b").smoke())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    model = get_model(get_config("glm4-9b").smoke(), device="cpu")
    params = params_from_jax(tree, model)
    np.testing.assert_array_equal(params["lm_head"].numpy(), tree["lm_head"])
    for name in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(params["blocks"]["attn"][name].numpy(),
                                      tree["blocks"]["attn"][name])
    assert not model.cfg.tie_embeddings and "lm_head" in model.param_spec()
    full = get_model(get_config("glm4-9b"), device="cpu").param_spec()
    assert full["lm_head"][0] == (4096, 151552)
    assert full["blocks"]["attn"]["bk"][0] == (40, 2 * 128)
    broken = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(broken, model)


@pytest.mark.cuda
def test_cuda_flash_prefill_equals_xla_prefill():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernel)")
    from repro_torch.kernels import flash_attention as fa

    base = get_config("glm4-9b").smoke()
    models = {impl: get_model(dataclasses.replace(base, attention_impl=impl),
                              device="cuda") for impl in ("xla", "flash")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = models["xla"].init(gen)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (2, 40))).cuda()
    before = fa.flash_attention.launches
    la, ca = models["flash"].prefill(params, toks)
    assert fa.flash_attention.launches == before + base.n_layers
    lb, cb = models["xla"].prefill(params, toks)
    torch.testing.assert_close(la, lb, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        assert torch.equal(ca["scan"][name][0], cb["scan"][name][0])
        torch.testing.assert_close(ca["scan"][name], cb["scan"][name],
                                   atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def vlm():
    """The smoke VLM's weights (JAX's init), a prompt, image embeddings and
    JAX's prefill of both."""
    cfg = jax_get_config("llava-next-mistral-7b").smoke()
    jm = jax_get_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    fe = rng.standard_normal((BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    jlogits, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(toks), jnp.asarray(fe))
    return dict(tree=jax.tree.map(np.asarray, jparams), toks=toks, fe=fe,
                jlogits=jlogits, jcache=jcache)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_vlm_prefill_with_frontend_embeds_matches_jax(vlm, impl):
    """The VLM's prefill with 8 image embeddings in the first slots (the
    anyres stub) equals JAX's, logits and k/v; the logits differ from the
    text-only prefill's (``tests/test_models_smoke.py:98``)."""
    model = get_model(dataclasses.replace(
        get_config("llava-next-mistral-7b").smoke(), attention_impl=impl),
        device="cpu")
    params = params_from_jax(vlm["tree"], model)
    toks, jlogits, jcache = vlm["toks"], vlm["jlogits"], vlm["jcache"]
    logits, cache = model.prefill(params, torch.from_numpy(toks),
                                  torch.from_numpy(vlm["fe"]))
    _close(logits, jlogits)
    for name in ("k", "v"):
        _close(cache["scan"][name], jcache["scan"][name])
    text, _ = model.prefill(params, torch.from_numpy(toks))
    assert (logits - text).abs().max() > 1e-3


def test_generate_takes_the_references_parameter_order(vlm):
    """``generate(prompts, frontend_embeds, max_new_tokens)``, as the
    reference's (``repro/serve/engine.py:209-214``): a call written for the
    reference, with the image embeddings passed by position, gives the
    reference's tokens on the smoke VLM."""
    import inspect

    want = list(inspect.signature(JaxGenerationEngine.generate).parameters)
    assert list(inspect.signature(GenerationEngine.generate).parameters) == want
    assert want == ["self", "prompts", "frontend_embeds", "max_new_tokens"]
    cfg = get_config("llava-next-mistral-7b").smoke()
    model = get_model(cfg, device="cpu")
    prompts = vlm["toks"].tolist()
    expect = JaxGenerationEngine(
        jax_get_model(jax_get_config("llava-next-mistral-7b").smoke()),
        jax.tree.map(jnp.asarray, vlm["tree"]),
        JaxGenerationConfig(max_new_tokens=NEW, eos_token=-1)).generate(
            prompts, jnp.asarray(vlm["fe"]))
    got = GenerationEngine(model, params_from_jax(vlm["tree"], model),
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1)
                           ).generate(prompts, torch.from_numpy(vlm["fe"]))
    assert got == expect and all(len(row) == NEW for row in got)
